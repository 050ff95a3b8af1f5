"""A cell of `BENCHMARK.json` and the files it names, found by name: its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), its limits (`limits/<workload>.json`), its
driver (`drivers/<driver>.py`, named by the mix), its model's family
(`families/<family>.py`, named by the configuration) and the readers of
its per-layer metrics (`metrics/<metric>.py`)."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list

    def model_config(self):
        """The port's config of the configuration file's ``model``: its
        family file's ``model_config(m)`` where it has one (a config class
        of the port alone), else the port's ModelConfig."""
        m = dict(self.config["model"])
        fam = family(m["family"])
        if hasattr(fam, "model_config"):
            return fam.model_config(m)
        from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                              MoEConfig, SSMConfig)
        m["attention"] = AttentionConfig(**m["attention"])
        m["moe"] = MoEConfig(**m["moe"])
        m["ssm"] = SSMConfig(**m["ssm"])
        return ModelConfig(**m)


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(workload: str, bench: dict | pathlib.Path | None = None) -> Cell:
    """Cell ``workload`` of ``bench`` (BENCHMARK.json's contents or its
    path; the repo's by default)."""
    if not isinstance(bench, dict):
        bench = _json(bench or ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: "
                       f"{sorted(cells)}")
    w = cells[workload]

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    return Cell(name=workload, workload=w,
                config=_json(HERE / "configs" / f"{w['config']}.json"),
                mix=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=_json(HERE / "limits" / f"{workload}.json"),
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def _module(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    """The driver the cell's mix names: a module with ``run(ctx)`` and
    ``KIND`` (``"serve"`` or ``"train"``)."""
    return importlib.import_module(f"cordbench.drivers.{cell.mix['driver']}")


def family(name: str):
    """What the harness needs of model family ``name``, from
    ``families/<name>.py``: ``layout(cfg)``, ``attention_windows(m)``,
    ``request_flops`` / ``logits_at`` where the family serves,
    ``train_step_flops`` / ``loss`` where it trains, and optionally
    ``model_config(m)``."""
    if not (HERE / "families" / f"{name}.py").is_file():
        known = sorted(p.stem for p in (HERE / "families").glob("*.py")
                       if p.stem != "__init__")
        raise KeyError(f"no family {name!r} under cordbench/families/; "
                       f"known: {known}")
    return importlib.import_module(f"cordbench.families.{name}")


def reader(metric: str):
    """The reader of per-layer metric ``metric``: ``read(run) -> value or
    None``."""
    return _module(HERE / "metrics" / f"{metric}.py",
                   "cordbench_metric_" + metric.replace(".", "_")
                   .replace("-", "_")).read
