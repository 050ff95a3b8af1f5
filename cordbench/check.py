"""The comparisons that decide `correct`, and the limits they are held to.

A cell's limits file (`limits/<workload>.json`) names each number that is
compared, its limit, and the readings the limit was set from.  A number
passes when it is finite and at most its limit.
"""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch


# ---------------------------------------------------------------------------
# serving: served tokens against the reference's logits
# ---------------------------------------------------------------------------

def token_gaps(ref_logits: torch.Tensor, tokens) -> np.ndarray:
    """For each position, how far the reference's logit of the served
    token lies below the reference's best logit there (0 when the served
    token is the reference's first choice)."""
    tok = torch.as_tensor(np.asarray(tokens), dtype=torch.long,
                          device=ref_logits.device)
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, tok[:, None])[:, 0]
    return (best - got).double().cpu().numpy()


def gap_readings(gaps: np.ndarray) -> dict:
    return {"widest_gap": float(gaps.max()), "mean_gap": float(gaps.mean()),
            "positions": int(gaps.size)}


def sample_requests(done: list, seed: int, min_tokens: int,
                    max_requests: int) -> list:
    """The longest finished request (prompt and output) and others drawn
    from the seed, until ``min_tokens`` served tokens are covered or
    ``max_requests`` are taken."""
    if not done:
        return []
    order = sorted(range(len(done)),
                   key=lambda i: -(len(done[i]["prompt"])
                                   + len(done[i]["tokens"])))
    rng = np.random.default_rng([int(seed), 0xC0DE])
    rest = list(rng.permutation(order[1:]))
    picked, served = [order[0]], len(done[order[0]]["tokens"])
    while rest and served < min_tokens and len(picked) < max_requests:
        i = int(rest.pop(0))
        picked.append(i)
        served += len(done[i]["tokens"])
    return [done[i] for i in picked]


# ---------------------------------------------------------------------------
# training: the program's steps against the reference's
# ---------------------------------------------------------------------------

def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Per leaf, |prog - ref| of the leaf's norms over the larger of the
    reference leaf's norm and the median reference leaf's; ``keep``
    limits the leaves compared."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in names}


def moving_leaves(grad1_ref: dict) -> set:
    """Leaves whose reference gradient is above a thousandth of the median
    leaf's: the others move under Adam by round-off alone."""
    med = statistics.median(grad1_ref.values())
    return {k for k, v in grad1_ref.items() if v >= 1e-3 * med}


def _worst(gaps: dict) -> tuple[float, str]:
    k = max(gaps, key=lambda n: gaps[n] if math.isfinite(gaps[n])
            else math.inf)
    return gaps[k], k


def train_readings(prog: dict, ref: dict) -> dict:
    """The worst step's relative loss gap, the worst leaf's first-gradient
    gap and the worst moving leaf's change gap, with the median leaf's
    and the three worst leaves beside them."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                   ref["losses"])]
    g1 = leaf_gaps(prog["grad1"], ref["grad1"])
    moving = moving_leaves(ref["grad1"])
    ch = leaf_gaps(prog["change"], ref["change"], moving)
    top = lambda g: sorted(((round(v, 8), k) for k, v in g.items()),  # noqa
                           reverse=True)[:3]
    return {"loss_gap": max(losses) if losses else math.inf,
            "grad1_gap": _worst(g1)[0], "change_gap": _worst(ch)[0],
            "grad1_leaf": _worst(g1)[1], "change_leaf": _worst(ch)[1],
            "grad1_median_gap": statistics.median(g1.values()),
            "change_median_gap": statistics.median(ch.values()),
            "grad1_top": top(g1), "change_top": top(ch),
            "steps": len(losses),
            "left_out": sorted(set(ref["change"]) - moving)}


# ---------------------------------------------------------------------------
# judging
# ---------------------------------------------------------------------------

def judge(readings: dict, limits: dict) -> tuple[bool, list]:
    """(every compared number within its limit, [(name, value, limit)])."""
    rows = []
    ok = True
    for name, spec in limits["compared"].items():
        value = float(readings.get(name, math.inf))
        rows.append((name, value, float(spec["limit"])))
        if not (math.isfinite(value) and value <= spec["limit"]):
            ok = False
    return ok, rows
