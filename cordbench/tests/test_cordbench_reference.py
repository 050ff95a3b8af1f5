"""The frozen plain references against `repro_torch` at smoke size, on the
same weights (the test may import the port; the references may not)."""

import dataclasses

import pytest
import torch

from cordbench import weights
from cordbench.reference import hybrid_lm, moe_lm
from cordbench.reference.common import Precision, layer_windows
from cordbench.tests import smoke


def _port(workload):
    from repro_torch.models import build_model
    cell = smoke.cell(workload)
    cfg = cell.model_config()
    return cell, cfg, build_model(cfg, device="cpu")


@pytest.mark.parametrize("workload", ["grok1-serve-burst",
                                      "hymba-train-dp2"])
def test_weight_layout_is_the_ports(workload):
    from repro_torch.core.tree import tree_flatten
    cell, cfg, model = _port(workload)
    ours = [(p, tuple(t.shape), t.dtype) for p, t in
            weights.leaves(weights.make(cfg, 3, "cpu"))]
    port = [(p, tuple(t.shape), t.dtype) for p, t in
            tree_flatten(model.init(0))]
    assert ours == port


def test_weights_follow_the_seed():
    cfg = smoke.cell("hymba-train-dp2").model_config()
    a, b = weights.make(cfg, 2**31 + 5, "cpu"), weights.make(cfg, 2**31 + 5,
                                                             "cpu")
    c = weights.make(cfg, 6, "cpu")
    la, lb, lc = (weights.leaves(x) for x in (a, b, c))
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    assert not torch.equal(la[0][1], lc[0][1])


def test_moe_reference_matches_the_port():
    from repro_torch.models.transformer import transformer_apply
    cell, cfg, model = _port("grok1-serve-burst")
    params = weights.make(cfg, 9, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 40),
                           generator=torch.Generator().manual_seed(1))
    x, *_ = transformer_apply(params, cfg, {"tokens": tokens})
    want = x[0].float() @ params["embed"]["tok"].t()
    got = moe_lm.logits_at(params, cell.config["model"], tokens[0],
                           torch.arange(40))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_moe_reference_soft_cap_and_gqa_bind():
    cell, cfg, _ = _port("grok1-serve-burst")
    m = cell.config["model"]
    params = weights.make(cfg, 9, "cpu")
    tokens = torch.arange(24) % cfg.vocab_size
    base = moe_lm.logits_at(params, m, tokens, torch.arange(24))
    uncapped = {**m, "attention": {**m["attention"], "logit_softcap": 0.0}}
    assert not torch.allclose(base, moe_lm.logits_at(
        params, uncapped, tokens, torch.arange(24)))


def test_hybrid_reference_loss_and_gradients_match_the_port():
    cell, cfg, model = _port("hymba-train-dp2")
    m = cell.config["model"]
    assert layer_windows(m) == [0, 8, 0, 0]       # smoke window 8, 4 layers
    params = weights.make(cfg, 4, "cpu")
    g = torch.Generator().manual_seed(2)
    rows = torch.randint(0, cfg.vocab_size, (2, 41), generator=g)
    batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    leaves = [t.detach().clone().requires_grad_(True)
              for _, t in weights.leaves(params)]
    paths = [p for p, _ in weights.leaves(params)]

    def tree(ts):
        out = {}
        for p, t in zip(paths, ts):
            node = out
            for k in p[:-1]:
                node = node.setdefault(k, {})
            node[p[-1]] = t
        return out

    loss, _ = model.loss(tree(leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    ref_leaves = [t.detach().clone().requires_grad_(True)
                  for _, t in weights.leaves(params)]
    ref = hybrid_lm.loss(tree(ref_leaves), m, batch["tokens"],
                         batch["labels"])
    ref_grads = torch.autograd.grad(ref, ref_leaves)
    torch.testing.assert_close(ref, loss, rtol=1e-5, atol=1e-5)
    for p, a, b in zip(paths, grads, ref_grads):
        torch.testing.assert_close(b, a, rtol=1e-3, atol=1e-5,
                                   msg=lambda s, p=p: f"{p}: {s}")


def test_chunked_scan_is_the_recurrence():
    g = torch.Generator().manual_seed(0)
    b, s, di, n = 2, 37, 5, 3
    dt = torch.rand(b, s, di, generator=g) * 0.5
    x = torch.randn(b, s, di, generator=g)
    a = -torch.rand(di, n, generator=g) * 2
    bb, cc = torch.randn(b, s, n, generator=g), torch.randn(b, s, n,
                                                             generator=g)
    h = torch.zeros(b, di, n)
    ys = []
    for t in range(s):
        h = torch.exp(dt[:, t, :, None] * a) * h + \
            (dt[:, t] * x[:, t])[..., None] * bb[:, t, None, :]
        ys.append((h * cc[:, t, None, :]).sum(-1))
    torch.testing.assert_close(hybrid_lm.scan(dt, x, a, bb, cc, chunk=8),
                               torch.stack(ys, 1), rtol=1e-5, atol=1e-5)


def test_fp8_products_round_coarser():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(64, 64, generator=g), torch.randn(64, 64, generator=g)
    exact = a @ b
    err = (Precision("fp8").mm(a, b) - exact).abs().max() / exact.abs().max()
    assert 1e-3 < err < 0.5
    assert torch.equal(Precision().mm(a, b), exact)
