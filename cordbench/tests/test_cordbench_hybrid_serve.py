"""`hymba-serve-chat`'s plain reference (`families/hybrid.logits_at`)
against the port's hybrid prefill and slot decode at smoke size, on the
same weights: the logits of a prompt longer than the smoke window and of
each decoded position."""

import torch

from cordbench import cells, weights
from cordbench.tests import smoke


def test_reference_matches_the_ports_prefill_and_slot_decode():
    from repro_torch.models import build_model
    cell = smoke.cell("hymba-serve-chat")
    cfg, m = cell.model_config(), cell.config["model"]
    assert m["attention"]["sliding_window"] == 8
    model = build_model(cfg, device="cpu")
    params = weights.make(cfg, 11, "cpu")
    g = torch.Generator().manual_seed(3)
    n, steps = 13, 6
    seq = torch.randint(0, cfg.vocab_size, (n + steps,), generator=g)
    cache = model.init_cache(1, n + steps + 1)
    logits, cache = model.prefill(params, {"tokens": seq[None, :n]}, cache)
    got = [logits[0, -1]]
    for t in range(steps):
        pos = torch.tensor([n + t], dtype=torch.int32)
        logits, cache = model.decode_step_slots(params, seq[None, n + t:
                                                           n + t + 1],
                                                cache, pos)
        got.append(logits[0, -1])
    want = cells.family("hybrid").logits_at(params, m, seq[:n + steps],
                                            torch.arange(n - 1, n + steps))
    torch.testing.assert_close(torch.stack(got).float(), want, rtol=1e-4,
                               atol=1e-4)
