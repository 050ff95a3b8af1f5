"""The CPU mirror of the f32 flash kernels' TF32 products,
``tools/flash_f32_precision.py``.

The f32 forward and backward of ``kernels/flash_attention/csrc/
flash_attention.cu`` split each f32 operand into two TF32 values and sum
three tensor-core products a k-step.  The mirror repeats that arithmetic
in plain torch, with the tensor core's sums rounded toward zero.  Held
here: its TF32 rounding is ``cvt.rna``'s (to nearest, ties away from
zero, 13 low bits cleared), the split's hi + lo carries x to within
2^-22 of |x|, and at train_lm's rank shape (11c: B=2 S=256, 8 over 4
heads, D 64) the three products hold every f32 gate of the card's checks
while one product misses them, so the mirror tells the two apart.  The gates are
the card's: the output within 2e-5, the lse within 2e-5 x max(1, |lse|)
and each gradient within 2e-5 x max(1, |plain|) of the plain versions;
a ratio is an error over its gate."""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from torch_port_util import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

_TOOL = pathlib.Path(__file__).resolve().parents[1] / "tools" / \
    "flash_f32_precision.py"


def _mirror():
    spec = importlib.util.spec_from_file_location("flash_f32_precision",
                                                  _TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


MIRROR = _mirror()


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),       # a tie goes away from zero
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
    (1.0 + 2.0**-11 - 2.0**-23, 1.0),         # below the tie: down
    (1.5, 1.5),                               # already TF32
    (3.0 * 2.0**-20, 3.0 * 2.0**-20)])
def test_tf32_rounds_as_cvt_rna(x, want):
    got = MIRROR.tf32(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want
    assert not (got.view(torch.int32) & 0x1FFF).any()


def test_hi_plus_lo_carries_x():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * 10.0 ** rng.uniform(-3, 3, 4096))
                         .astype(np.float32))
    hi, lo = MIRROR.split(x)
    assert not ((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF).any()
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= 2.0**-22 * x.double().abs()).all())
    assert bool(((hi - x).abs() <= 2.0**-11 * x.abs()).all())


def test_three_products_hold_the_gates_and_one_does_not():
    res = MIRROR.ratios(MIRROR.CASES["11c"], seed=0,
                        candidates=("tf32x1", "tf32x3"))
    three, one = res["tf32x3"], res["tf32x1"]
    assert set(three) == {"o", "lse", "dq", "dk", "dv"}
    assert max(three.values()) <= 1.0, three
    assert min(one.values()) > 1.0, one
