"""A cell of `BENCHMARK.json` and the files it names, found by name: its
configuration (`configs/<config>.json`), its traffic mix
(`traffic/<traffic>.json`), its limits (`limits/<workload>.json`), its
driver (`drivers/<driver>.py`, named by the mix) and the readers of its
per-layer metrics (`metrics/<metric>.py`)."""

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
        """The port's ModelConfig built from the configuration file."""
        from repro_torch.configs.base import (AttentionConfig, ModelConfig,
                                              MoEConfig, SSMConfig)
        m = dict(self.config["model"])
        m["attention"] = AttentionConfig(**m["attention"])
        m["moe"] = MoEConfig(**m["moe"])
        m["ssm"] = SSMConfig(**m["ssm"])
        return ModelConfig(**m)


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(workload: str, bench_path: pathlib.Path | None = None) -> Cell:
    bench = _json(bench_path or ROOT / "BENCHMARK.json")
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
    return importlib.import_module(f"cordbench.drivers.{cell.mix['driver']}")


def reader(metric: str):
    """The reader of per-layer metric ``metric``: ``read(run) -> value or
    None``."""
    return _module(HERE / "metrics" / f"{metric}.py",
                   "cordbench_metric_" + metric.replace(".", "_")
                   .replace("-", "_")).read
