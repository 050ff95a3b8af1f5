"""`moe_cast_held_share` on traced smoke runs of `grok1-serve-burst` whose
model computes in bfloat16 over the float32 weights, as the cell's does:
100 % where the engine holds its bfloat16 copy of the experts, 0 % where
the copy does not fit and every layer call casts, and None where no span
records it."""

import json

import pytest

from cordbench import cells, program_spans, run
from cordbench.tests import smoke

SERVE = "grok1-serve-burst"
METRIC = "moe_cast_held_share"


def _traced(monkeypatch, fits: bool, trace: bool = True):
    import repro_torch.serve.engine as engine_mod
    from repro_torch.core import clear_spans
    monkeypatch.setattr(engine_mod, "_copy_fits", lambda n, dev: fits)
    clear_spans()
    ctx = smoke.ctx(SERVE, seed=2**31 + 37, trace=trace)
    ctx.cell.config["model"]["dtype"] = "bfloat16"
    out, ok, rows = run.execute(ctx)
    line = json.loads(json.dumps(run.result(ctx, out, ok, rows)))
    value = cells.reader(METRIC)(out.record)
    casts = program_spans.named(out.record, "moe.cast")
    clear_spans()
    return line, value, casts


@pytest.mark.parametrize("fits,share", [(True, 100.0), (False, 0.0)])
def test_held_share_reads_the_engines_path(monkeypatch, fits, share):
    line, value, casts = _traced(monkeypatch, fits)
    assert casts and {s.attrs["held"] for s in casts} == {fits}
    assert value == share
    assert line["metrics"][METRIC] == {"value": share, "unit": "%"}


def test_held_share_is_none_without_spans(monkeypatch):
    line, value, casts = _traced(monkeypatch, True, trace=False)
    assert value is None and casts == []
    assert cells.reader(METRIC)({"spans": None, "prof": None}) is None


def test_held_share_is_none_where_spans_lack_the_attribute(monkeypatch):
    """A program that records `moe.cast` without `held` reads None."""
    from repro_torch.core.obs import Span
    spans = [Span(i, "moe.cast", None, 0, 1, attrs={"leaf": "wi"})
             for i in range(3)]
    monkeypatch.setattr(program_spans, "recorded",
                        lambda run: (spans, 0.0))
    assert cells.reader(METRIC)({}) is None
    spans[0].attrs["held"] = True
    assert cells.reader(METRIC)({}) is None
    for s in spans:
        s.attrs["held"] = s is not spans[2]
    assert cells.reader(METRIC)({}) == pytest.approx(200 / 3)
