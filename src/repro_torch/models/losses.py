"""Loss functions.  Cross-entropy is computed in sequence chunks, each
rematerialised (``models/remat.py``), so the (B, chunk, vocab) float32
logits are recomputed in the backward instead of saved: at vocab 262144
one chunk of 4 x 256 positions is 1.07 GB.  Each chunk's logits cross
the dataplane as ``loss/logits``, as in ``repro``."""

from __future__ import annotations

import torch

from repro_torch.layers.common import constrain
from repro_torch.models.remat import remat


def _chunk_terms(xi, li, table, softcap_val: float, dp=None):
    """(sum nll, correct, count) of one chunk: float32 logits of the
    working-dtype hiddens against the table cast to the working dtype
    (``preferred_element_type=float32`` in ``repro``)."""
    logits = torch.matmul(xi.float(), table.to(xi.dtype).float().t())
    if softcap_val > 0:
        logits = softcap_val * torch.tanh(logits / softcap_val)
    logits = constrain(dp, logits, ("batch", "seq", "vocab"),
                       tag="loss/logits")
    mask = li >= 0
    safe = torch.where(mask, li, torch.zeros_like(li)).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(mask, lse - gold, torch.zeros_like(lse))
    pred = logits.argmax(dim=-1)
    correct = (mask & (pred == safe)).sum(dtype=torch.int32)
    return nll.sum(), correct, mask.sum(dtype=torch.int32)


def chunked_ce_loss(x: torch.Tensor, table: torch.Tensor,
                    labels: torch.Tensor, *, dp=None, chunk: int = 512,
                    softcap_val: float = 0.0):
    """Cross entropy of final hiddens ``x`` (B,S,D) against ``labels``
    (B,S; -1 = ignore) with the tied or untied vocab ``table`` (V,D).

    Returns (sum_loss float32, sum_correct int32, sum_count int32)."""
    b, s, d = x.shape
    ck = min(chunk, s)
    while s % ck:
        ck -= 1
    table = constrain(dp, table, ("vocab", "embed"), tag="loss/table")
    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    correct = torch.zeros((), dtype=torch.int32, device=x.device)
    count = torch.zeros((), dtype=torch.int32, device=x.device)
    for i in range(0, s, ck):
        terms = remat("full", dp, _chunk_terms, x[:, i:i + ck],
                      labels[:, i:i + ck], table, softcap_val, dp)
        loss = loss + terms[0]
        correct = correct + terms[1]
        count = count + terms[2]
    return loss, correct, count


def ce_metrics(loss, correct, count, aux=0.0) -> dict:
    n = torch.clamp(count, min=1)
    return {"loss": loss / n + aux, "nll": loss / n, "acc": correct / n,
            "tokens": count, "aux": aux}


__all__ = ["chunked_ce_loss", "ce_metrics"]
