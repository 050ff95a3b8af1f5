"""The train state is donated, as ``repro``'s jitted steps donate it:
``adamw_update`` writes the parameters and moments in place, bit for bit
what the out-of-place formula (frozen here as it stood before) computes;
the launcher holds no reference to the state it hands to ``run_loop``;
``run_loop``'s async checkpoint holds the state of its own step although
the next step writes the same tensors; and the launcher still resumes.
Tolerance: exact throughout."""

import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import store
from repro_torch.configs.base import TrainConfig
from repro_torch.core.tree import tree_flatten, tree_leaves, tree_map
from repro_torch.core.tree import tree_unflatten
from repro_torch.launch import train as launch_train
from repro_torch.optim import adamw as tadamw
from repro_torch.runtime import fault

from torch_port_util import one_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


def _frozen_update(grads, state, params, cfg):
    """``adamw_update`` as it was before the update went in place: new
    parameters and moments, the inputs untouched."""
    schedule = tadamw.warmup_cosine(cfg)
    grads, _ = tadamw.clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = schedule(step)
    b1, b2, eps, wd = cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay
    bc1 = 1.0 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1.0 - torch.pow(b2, step.to(torch.float32))

    def upd(p, g, m, v):
        g = g.float()
        m32 = b1 * m.float() + (1 - b1) * g
        v32 = b2 * v.float() + (1 - b2) * g.square()
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + eps) + wd * p.float()
        return ((p.float() - lr * delta).to(p.dtype), m32.to(m.dtype),
                v32.to(v.dtype))

    paths = [p for p, _ in tree_flatten(params)]
    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu),
        tree_leaves(state.nu))]
    new = [tree_unflatten(paths, [o[i] for o in out]) for i in range(3)]
    return new[0], tadamw.AdamWState(step=step, mu=new[1], nu=new[2])


def _tree(gen, scale=1.0):
    return {"embed": {"tok": scale * torch.randn(64, 24, generator=gen)},
            "layers": {"w": scale * torch.randn(3, 24, 40, generator=gen),
                       "norm": {"scale": scale * torch.randn(3, 24,
                                                             generator=gen)}},
            "final": scale * torch.randn(24, generator=gen)}


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
def test_in_place_update_is_bit_for_bit_the_old_one(opt_dtype):
    cfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, steps=10,
                      grad_clip=1.0, weight_decay=0.1, opt_dtype=opt_dtype)
    gen = torch.Generator().manual_seed(0)
    params = _tree(gen)
    ref_p = tree_map(torch.clone, params)
    st = tadamw.adamw_init(params, opt_dtype)
    ref_st = tadamw.adamw_init(ref_p, opt_dtype)
    ptrs = [t.data_ptr() for t in tree_leaves(
        {"p": params, "m": st.mu, "n": st.nu})]
    for i in range(3):
        # gradients from tiny to large, so the clip and eps both matter
        grads = _tree(gen, scale=10.0 ** (i - 2))
        ref_p, ref_st = _frozen_update(grads, ref_st, ref_p, cfg)
        out_p, st, _ = tadamw.adamw_update(grads, st, params, cfg)
        assert out_p is params
    got = {"p": params, "m": st.mu, "n": st.nu}
    want = {"p": ref_p, "m": ref_st.mu, "n": ref_st.nu}
    for (path, a), (_, b) in zip(tree_flatten(got), tree_flatten(want)):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    assert [t.data_ptr() for t in tree_leaves(got)] == ptrs
    assert int(st.step) == 3


def test_launcher_holds_no_reference_to_the_state(monkeypatch):
    """The state reaches ``run_loop`` with no other reference than its
    own argument (counted as a temporary passed the same way is)."""
    counts = []
    real = launch_train.run_loop

    def counting(step_fn, state, loader, **kw):
        counts.append(sys.getrefcount(state))
        return real(step_fn, state, loader, **kw)

    def probe(step_fn, state, loader, **kw):
        return sys.getrefcount(state)

    baseline = probe(None, (object(),), None)
    monkeypatch.setattr(launch_train, "run_loop", counting)
    launch_train.main(["--device", "cpu", "steps=1", "seq_len=8",
                       "global_batch=2"])
    assert counts == [baseline]


def test_async_checkpoint_holds_its_own_step(tmp_path):
    """Every step writes the same tensors in place; each async checkpoint
    still holds the state of the step it was taken at."""
    gen = torch.Generator().manual_seed(1)
    cfg = TrainConfig(learning_rate=1e-2, warmup_steps=1, steps=4)
    params = _tree(gen)
    state = {"params": params, "opt": tadamw.adamw_init(params)}
    grads = [_tree(gen) for _ in range(4)]
    seen = {}

    def step_fn(s, batch):
        p, opt, _ = tadamw.adamw_update(grads[batch], s["opt"], s["params"],
                                        cfg)
        new = {"params": p, "opt": opt}
        seen[int(opt.step)] = tree_map(torch.clone, {"params": p,
                                                     "mu": opt.mu})
        return new, {"loss": torch.zeros(())}

    class Loader:
        def get(self, step):
            return step

    state, rep = fault.run_loop(step_fn, state, Loader(), steps=4,
                                ckpt_dir=str(tmp_path), checkpoint_every=1,
                                keep_last=4, async_ckpt=True)
    assert store.all_steps(str(tmp_path)) == [1, 2, 3, 4]
    for k in (1, 2, 3):
        back = store.restore(str(tmp_path), k, state)
        for (path, a), (_, b) in zip(
                tree_flatten({"params": back["params"],
                              "mu": back["opt"].mu}),
                tree_flatten(seen[k])):
            assert torch.equal(a, b), (k, path)
        assert not torch.equal(back["params"]["final"],
                               state["params"]["final"])


def test_launcher_resume_matches_an_unbroken_run(tmp_path):
    """Three steps in one run, and two then a resumed third: the same
    parameters and moments bit for bit."""
    common = ["--device", "cpu", "seq_len=8", "global_batch=2"]
    whole, _ = launch_train.main(common + ["steps=3"])
    ck = [f"checkpoint_dir={tmp_path}", "checkpoint_every=2"]
    launch_train.main(common + ["steps=2"] + ck)
    resumed, rep = launch_train.main(common + ["steps=3"] + ck)
    assert rep.restores == 1 and rep.steps_run == 1
    for (path, a), (_, b) in zip(
            tree_flatten({"p": whole.params, "m": whole.opt.mu,
                          "n": whole.opt.nu}),
            tree_flatten({"p": resumed.params, "m": resumed.opt.mu,
                          "n": resumed.opt.nu})):
        assert torch.equal(a, b), path
    assert np.isfinite(rep.metrics[0]["loss"])
