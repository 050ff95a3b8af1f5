"""On the card: each cell once, briefly, correct, with its contract line."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run on the card only")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["grok1-serve-burst",
                                      "hymba-train-dp2",
                                      "grok1-prefill-long"])
def test_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "cordbench/run.py", "--workload", workload,
         "--seed", "3000000019", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, out.stderr[-4000:]
    assert line["device"]["platform"] == "gpu"
