"""A configuration of an architecture outside the port's registry, with a
family, a config class and a driver of its own, joins the benchmark as
new files and appended entries only: in a copy of `cordbench/` whose
existing files are left as they are, it loads through `cells.load`, its
layout, reference and FLOPs are found, and the benchmark's structure
checks pass for it."""

import copy
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

from cordbench.tests.test_cordbench_benchmark import _published_cuts

ROOT = pathlib.Path(__file__).resolve().parents[2]

FAMILY = '''"""A toy family: an embedding, stacked gated MLP blocks, no attention."""

import dataclasses
import math

import torch
import torch.nn.functional as F

from cordbench import flops, weights
from cordbench.reference.common import Precision, layer, rmsnorm


@dataclasses.dataclass(frozen=True)
class ToyConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    gated_mlp: bool
    norm_eps: float


def model_config(m):
    return ToyConfig(**m)


def attention_windows(m):
    return []


def layout(cfg):
    d = cfg.d_model
    return sorted([(("embed", "tok"), (cfg.vocab_size, d), "normal", 1 / d),
                   (("final_norm", "scale"), (d,), "norm", 0.1)]
                  + [(("layers",) + p, s, law, sc)
                     for p, s, law, sc in weights.mlp_leaves(cfg)])


def request_flops(m, prompt, new):
    return flops.serve_flops(m, prompt, new,
                             m["num_layers"] * flops.mlp_params(m), [])


@torch.no_grad()
def logits_at(params, mcfg, tokens, positions, prec=None, margins=None):
    prec = prec or Precision()
    tab = params["embed"]["tok"]
    x = tab[tokens].float() * math.sqrt(mcfg["d_model"])
    for i in range(mcfg["num_layers"]):
        p = layer(params["layers"], i)["mlp"]
        x = x + prec.mm(F.silu(prec.mm(x, p["wg"])) * prec.mm(x, p["wi"]),
                        p["wo"])
    x = rmsnorm(x, params["final_norm"]["scale"], mcfg["norm_eps"])
    return prec.mm(x[positions], tab.t())
'''

DRIVER = '''"""A toy driver: the serve waves under a name of its own."""

from cordbench.drivers.serve_waves import run  # noqa: F401

KIND = "serve"
'''

CONFIG = {
    "name": "toy-mlp", "arch": "toy-mlp-1", "source": "https://example.org/toy-mlp-1",
    "deployment": "one stage of two: 2 of the toy's 4 layers on this chip",
    "model": {"name": "toy-mlp-1", "family": "toy", "num_layers": 2,
              "d_model": 32, "d_ff": 64, "vocab_size": 128,
              "gated_mlp": True, "norm_eps": 1e-6},
    "published": {"hidden_size": 32, "intermediate_size": 64,
                  "num_hidden_layers": 4, "vocab_size": 128,
                  "rms_norm_eps": 1e-6},
    "published_keys": {"d_model": "hidden_size", "d_ff": "intermediate_size",
                       "num_layers": "num_hidden_layers",
                       "vocab_size": "vocab_size", "norm_eps": "rms_norm_eps"},
    "unpublished": {"name": "the port's name for the configuration",
                    "family": "the harness's family file",
                    "gated_mlp": "the source names no activation; the toy "
                                 "family's MLP is SiLU-gated"},
    "hidden_size": 32, "num_hidden_layers": 2,
    "reduced": {"num_hidden_layers": {"published": 4, "here": 2,
                                      "why": "two pipeline stages"}},
    "assumed": {}}

PROBE = """
import sys, torch
from cordbench import cells, weights
c = cells.load("toy-chat")
cfg = c.model_config()
assert type(cfg).__name__ == "ToyConfig", type(cfg)
fam = cells.family(cfg.family)
params = weights.make(cfg, 7, "cpu")
assert [p for p, _ in weights.leaves(params)] == \\
    [p for p, *_ in weights.layout(cfg)]
m = c.config["model"]
logits = fam.logits_at(params, m, torch.arange(5), torch.arange(2, 5))
assert logits.shape == (3, 128) and torch.isfinite(logits).all()
# 4 fed tokens through 2 layers of 3 x 32 x 64, 2 logits of 128 x 32
assert fam.request_flops(m, 3, 2) == 4 * 2 * 2 * 6144 + 2 * 2 * 128 * 32
assert cells.driver(c).KIND == "serve" and callable(cells.driver(c).run)
import pytest
sys.exit(pytest.main(["-q", "-p", "no:cacheprovider", "-rA",
                      "cordbench/tests/test_cordbench_benchmark.py"]))
"""


def _add(root: pathlib.Path) -> None:
    """The toy's files, and its entries appended to BENCHMARK.json."""
    cb = root / "cordbench"
    for rel, text in (("families/toy.py", FAMILY),
                      ("drivers/toy_waves.py", DRIVER),
                      ("configs/toy-mlp.json", json.dumps(CONFIG)),
                      ("limits/toy-chat.json", json.dumps(
                          {"compared": {"mean_gap": {"limit": 1e-3}}}))):
        assert not (cb / rel).exists(), rel
        (cb / rel).write_text(text)
    mix = json.loads((cb / "traffic" / "serve_chat.json").read_text())
    (cb / "traffic" / "toy_chat.json").write_text(
        json.dumps({**mix, "driver": "toy_waves"}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "toy-mlp", "source": CONFIG["source"],
        "file": "cordbench/configs/toy-mlp.json",
        "reduced": ["num_hidden_layers"], "why": "a family of its own"})
    bench["workloads"].append({
        "name": "toy-chat", "config": "toy-mlp", "traffic": "toy_chat",
        "chips": 1, "why": "a new family, driver and config as files"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in ("serve_tok_s", "slot_occupancy"):
            m["workloads"].append("toy-chat")
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))


def test_new_family_driver_and_config_join_as_files(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "cordbench", tmp_path / "cordbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "cordbench").rglob("*") if p.is_file()}
    _add(tmp_path)
    for rel, data in before.items():       # no existing file was edited
        assert (tmp_path / rel).read_bytes() == data, rel
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join([str(tmp_path), str(ROOT / "src")])
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    for name in ("test_cell_files_and_metrics[toy-chat]",
                 "test_config_files_state_their_cuts[toy-mlp]"):
        assert f"PASSED cordbench/tests/test_cordbench_benchmark.py::{name}" \
            in out.stdout, out.stdout[-3000:]


@pytest.mark.parametrize("change", ["model", "top", "reduced_same",
                                    "unmapped_width", "width_unpublished",
                                    "unmapped_no_why"])
def test_published_cuts_refuse_an_unstated_change(change):
    doc = copy.deepcopy(CONFIG)
    _published_cuts(doc, ["num_hidden_layers"])
    if change == "model":
        doc["model"]["d_ff"] = 96               # differs, not in reduced
    elif change == "top":
        doc["hidden_size"] = 48                 # the source's key, changed
    elif change == "reduced_same":
        doc["reduced"]["num_hidden_layers"]["here"] = 4
    elif change == "unmapped_width":
        del doc["published_keys"]["d_ff"]       # a width left unchecked
    elif change == "width_unpublished":
        del doc["published_keys"]["d_ff"]
        doc["unpublished"]["d_ff"] = "said to be the port's own"
    else:
        del doc["unpublished"]["gated_mlp"]     # neither mapped nor stated
    with pytest.raises(AssertionError):
        _published_cuts(doc, ["num_hidden_layers"])
