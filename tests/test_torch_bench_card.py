"""Card tests of the paths the port's benchmarks add: the flash kernels at
the shapes the converged scenario and the serve comparison give them on
full-width gemma3-1b, and the NPB suite on the card.  Every test here is
marked ``cuda`` and skips without a card; the file imports no JAX.

Tolerances: the bf16 forward against its plain version at 2e-2 (rtol and
atol), the lse at 2e-5 x max(1, |lse|), as tests/test_torch_attention.py
holds them; the bf16 backward, each gradient at cosine > 0.999 and within
2e-2 x max |plain|, two calls bit for bit, as
tests/test_torch_flash_bwd_kernel.py holds it.  NPB: each kernel's output
the same bits in bypass, cord and socket mode, and the bounce launches of
one CG call exactly its mediated collectives times the ranks and the
pipeline sides with work (cord 1, socket 2, bypass none)."""

import numpy as np
import pytest
import torch

from repro_torch.bench import npb
from repro_torch.kernels.dataplane import bounce
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention import ref as fref

from torch_port_util import bits, cuda_device

BF16_TOL = 2e-2
LSE_TOL = 2e-5
BF16_COS = 0.999
HEADS = (4, 1, 256)         # gemma3-1b: H, KVH, D
WINDOW = 512


def _qkv(b, s, seed):
    h, kvh, d = HEADS
    rng = np.random.default_rng(seed)
    dev = cuda_device()
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            .to(dev, torch.bfloat16)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d),
                          (b, s, h, d))]


def _cos(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp(min=1e-300))


@pytest.mark.cuda
def test_flash_at_the_converged_train_shape():
    """A rank's 2 x 32 of the converged step: the forward with its lse and
    the backward, bf16, causal, window 512."""
    q, k, v, do = _qkv(2, 32, seed=32)
    kw = dict(causal=True, window=WINDOW, logit_cap=0.0)
    o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    po, plse = ops.flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(o.float(), po.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)
    assert bool(((lse - plse).abs()
                 <= LSE_TOL * plse.abs().clamp(min=1.0)).all())
    n0 = ops.BWD_LAUNCHES
    got = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = ops.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    want = fref.flash_attention_bwd_plain(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert ops.BWD_LAUNCHES - n0 == 2
    for name, g, g2, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16, name
        assert torch.equal(g.view(torch.int16), g2.view(torch.int16)), name
        assert _cos(g.float(), w.float()) > BF16_COS, name
        assert (g.float() - w.float()).abs().max() <= \
            BF16_TOL * w.float().abs().max(), name


# the serve comparison's whole prefills: (bucket, valid length) of its
# prompts of 5-15 tokens, the long 40 and the 80 the paged engine admits
@pytest.mark.cuda
@pytest.mark.parametrize("s,valid", [(8, 5), (16, 15), (16, 9), (64, 40),
                                     (128, 80), (80, None)])
def test_flash_at_the_serve_prefill_buckets(s, valid):
    q, k, v, _ = _qkv(1, s, seed=s)
    got = ops.flash_attention(q, k, v, window=WINDOW, valid_len=valid)
    want = ops.flash_attention_plain(q, k, v, window=WINDOW,
                                     valid_len=valid)
    torch.testing.assert_close(got.float(), want.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(npb.BENCHES))
def test_npb_modes_bit_identical_on_card(name):
    dev = cuda_device()
    outs = {}
    npb.run_all(benches=(name,), device=dev, outputs=outs)
    ref = bits(outs[(name, "bypass")])
    for mode in ("cord", "socket"):
        assert np.array_equal(bits(outs[(name, mode)]), ref), mode


@pytest.mark.cuda
@pytest.mark.parametrize("mode,sides", [("bypass", 0), ("cord", 1),
                                        ("socket", 2)])
def test_cg_bounce_launches(mode, sides):
    """One CG call: a psum, then 12 iterations of two halos and two
    psums, each launching the kernel once a rank and side with work."""
    dev = cuda_device()
    mesh = npb.make_mesh()
    dp = npb.make_dp(mode, mesh, device=dev)
    fn = npb.build_cg(mesh, dp)
    arg = npb.BENCHES["CG"][1](dev)
    fn(arg, dp.runtime_init())              # the build and warm-up
    n0 = bounce.LAUNCHES
    fn(arg, dp.runtime_init())
    torch.cuda.synchronize()
    assert bounce.LAUNCHES - n0 == (1 + 12 * 4) * npb.RANKS * sides
