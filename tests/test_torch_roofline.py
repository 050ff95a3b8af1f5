"""The port's roofline (``repro_torch.analysis.roofline``) against
``benchmarks/roofline.py`` on the same cell records: cells that the port's
dry run traces (smoke configs at the production shapes, on ``meta``),
read by both.  ``repro``'s side runs with ``use_hlo=False`` (the port
saves no HLO) and reads ``memory_analysis`` fields that the port's cells
do not have; they are added to its copy as None.

Tolerance: exact.  Every field that does not depend on the peaks is
equal on the same record (the arithmetic is the same); the peak-dependent
ones (the three terms, ``dominant``, ``roofline_fraction``) are equal
once ``repro``'s TPU v5e constants are set to the port's H100 figures.
``suggestion`` is keyed by ``dominant``, with the text written for the
card.  The fields without a counterpart in the port's cells
(``lower_s``, ``compile_s``, ``memory_temp_gib``, ``memory_args_gib``)
are None."""

import json

import pytest

from benchmarks import roofline as jroof

from repro_torch.analysis import roofline as troof
from repro_torch.configs import get_model_config as tget
from repro_torch.launch import dryrun

CELLS = (("gemma3-1b", "decode_32k", False), ("gemma3-1b", "train_4k", True),
         ("hymba-1.5b", "prefill_32k", False))
PEAK_FIELDS = ("compute_s", "memory_s", "collective_s", "dominant",
               "roofline_fraction", "suggestion")
NO_COUNTERPART = ("lower_s", "compile_s", "memory_temp_gib",
                  "memory_args_gib")


@pytest.fixture(scope="module")
def cell_dir(tmp_path_factory):
    """The port's dry-run JSON of CELLS, smoke configs at full shapes."""
    out = tmp_path_factory.mktemp("dryrun")
    real = dryrun.get_model_config
    dryrun.get_model_config = lambda name, **kw: tget(name, smoke=True)
    try:
        for arch, shape, mp in CELLS:
            tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
            assert dryrun._write_cell((str(out / f"{tag}.json"), arch, shape,
                                       mp, "full", True))
    finally:
        dryrun.get_model_config = real
    return out


def _jax_copy(path, tmp_path):
    rec = json.loads(path.read_text())
    rec["memory"] = {"temp_bytes": None, "argument_bytes": None}
    copy = tmp_path / path.name
    copy.write_text(json.dumps(rec))
    return str(copy)


@pytest.mark.parametrize("same_peaks", [False, True])
def test_rows_match(cell_dir, tmp_path, monkeypatch, same_peaks):
    if same_peaks:
        monkeypatch.setattr(jroof, "PEAK_FLOPS", troof.PEAK_FLOPS)
        monkeypatch.setattr(jroof, "HBM_BW", troof.HBM_BW)
        monkeypatch.setattr(jroof, "ICI_BW", troof.LINK_BW)
    paths = sorted(cell_dir.glob("*.json"))
    assert len(paths) == len(CELLS)
    for path in paths:
        got = troof.analyze_cell(str(path))
        want = jroof.analyze_cell(_jax_copy(path, tmp_path), use_hlo=False)
        assert set(got) == set(want)
        for key in NO_COUNTERPART:
            assert got[key] is None
        skip = set(NO_COUNTERPART) | {"suggestion"}
        if not same_peaks:
            skip |= set(PEAK_FIELDS)
        assert {k: v for k, v in got.items() if k not in skip} == \
            {k: v for k, v in want.items() if k not in skip}
        assert got["suggestion"] == troof._SUGGEST[got["dominant"]]


def test_link_bandwidth_is_an_argument(cell_dir):
    path = str(sorted(cell_dir.glob("*train_4k*.json"))[0])
    base = troof.analyze_cell(path)
    half = troof.analyze_cell(path, link_bw=troof.LINK_BW / 2)
    assert base["collective_s"] > 0
    assert half["collective_s"] == pytest.approx(2 * base["collective_s"])
    assert half["compute_s"] == base["compute_s"]


def test_run_all_and_main(cell_dir, tmp_path):
    """A row per traced cell; a failed trace gives none, an unreadable
    file an error row; ``main`` prints the table and writes the rows."""
    d = tmp_path / "cells"
    d.mkdir()
    for path in cell_dir.glob("*.json"):
        (d / path.name).write_text(path.read_text())
    (d / "failed.json").write_text(json.dumps({"ok": False, "error": "x"}))
    (d / "broken.json").write_text("{")
    rows = troof.run_all(str(d))
    assert len(rows) == len(CELLS) + 1
    assert [r for r in rows if "error" in r][0]["arch"] == "broken.json"
    table = troof.markdown_table(rows)
    assert table.count("\n") == len(rows) + 1 and "ERROR" in table
    out = tmp_path / "roofline.json"
    (d / "broken.json").unlink()
    assert troof.main(["--dryrun-dir", str(d), "--out", str(out)]) == \
        json.loads(out.read_text())
    assert len(json.loads(out.read_text())) == len(CELLS)
