"""Roofline analysis over the dry run's cells; the port of
``benchmarks/roofline.py``.

    python -m repro_torch.analysis.roofline [--dryrun-dir runs/torch/dryrun]
        [--link-bw BYTES_PER_S] [--out runs/torch/roofline.json]

Reads the JSON cells that ``repro_torch.launch.dryrun`` writes and
derives, per (arch × shape × mesh):

    compute term    = FLOPs per device / 989 TFLOP/s (H100 SXM, dense bf16)
    memory term     = bytes per device / 3.35 TB/s (H100 SXM HBM3)
    collective term = collective bytes per device / the link bandwidth

The FLOPs and bytes are the cost counter's (``analysis/cost.py``) for the
traced call, which counts every executed op, loops included, so there is
no undercount to correct: ``repro``'s reanalysis of the saved HLO has no
counterpart, and ``corrected_flops_per_device`` is the counter's figure.
The link bandwidth is an argument; its default is one H100's NVLink 4
(18 links, 450 GB/s each way), a planning figure the one-card box cannot
measure.  MODEL_FLOPS = 6·N·D (train) / 2·N·D (prefill) / 2·N·B (decode),
with N = active params; the ratio MODEL/counted flags remat and
redundancy.  Fields with no counterpart in the port's cells (``lower_s``,
``compile_s``, ``memory_temp_gib``, ``memory_args_gib``: XLA's compile
times and ``memory_analysis``) are None.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

PEAK_FLOPS = 989e12          # bf16 per card (H100 SXM, dense)
HBM_BW = 3.35e12             # bytes/s per card (H100 SXM HBM3)
LINK_BW = 450e9              # bytes/s per card each way (NVLink 4)

_SUGGEST = {
    "compute": "increase arithmetic efficiency (larger per-card batch, "
               "fuse elementwise into matmuls) or accept — compute-bound is "
               "the roofline target",
    "memory": "cut HBM traffic: fuse/remat less, larger blocks (hand "
              "kernels), bf16 residents, avoid padded/replicated buffers",
    "collective": "reshard to shrink the dominant collective (different "
                  "TP/EP split), chunk + overlap collectives with compute, "
                  "or compress the payload",
}


def model_flops(meta: dict) -> float:
    n = meta.get("active_params") or meta.get("params", 0)
    kind = meta["kind"]
    shape_tokens = {"train": 4096 * 256, "prefill": 32768 * 32}
    if meta["shape"] == "long_500k":
        tokens = 1
    elif kind == "decode":
        tokens = 128
    else:
        tokens = shape_tokens.get(kind, 0)
        if meta["shape"] == "train_4k":
            tokens = 4096 * 256
        elif meta["shape"] == "prefill_32k":
            tokens = 32768 * 32
    mult = 6 if kind == "train" else 2
    return mult * n * tokens


def analyze_cell(path: str, *, link_bw: float = LINK_BW) -> dict | None:
    """One cell's row, or None for a cell whose trace failed."""
    with open(path) as f:
        rec = json.load(f)
    if not rec.get("ok"):
        return None
    chips = 512 if rec["multi_pod"] else 256

    flops_dev = rec["cost"]["flops_per_device"] or 0
    bytes_dev = rec["cost"]["bytes_per_device"] or 0
    coll_dev = rec.get("collective_bytes_total", 0)

    t_comp = flops_dev / PEAK_FLOPS
    t_mem = bytes_dev / HBM_BW
    t_coll = coll_dev / link_bw
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dom = max(terms, key=terms.get)
    mf = model_flops(rec)
    mf_dev = mf / chips
    return {
        "arch": rec["arch"], "shape": rec["shape"],
        "mesh": "2x16x16" if rec["multi_pod"] else "16x16",
        "chips": chips,
        "compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll,
        "dominant": dom,
        "model_flops_per_device": mf_dev,
        "useful_flops_ratio": (mf_dev / flops_dev) if flops_dev else 0.0,
        "roofline_fraction": (mf_dev / PEAK_FLOPS) / max(terms[dom], 1e-30),
        "xla_flops_per_device": rec["cost"]["flops_per_device"],
        "corrected_flops_per_device": flops_dev,
        "suggestion": _SUGGEST[dom],
        "lower_s": None, "compile_s": None,
        "memory_temp_gib": None, "memory_args_gib": None,
        "params_gib_dev": rec.get("params_bytes_per_device", 0) / 2**30,
        "cache_gib_dev": rec.get("cache_bytes_per_device", 0) / 2**30,
    }


def run_all(dryrun_dir: str = "runs/torch/dryrun", *,
            link_bw: float = LINK_BW) -> list[dict]:
    """A row per cell of ``dryrun_dir``; a cell that cannot be read gives
    an ``error`` row, a failed trace none."""
    rows = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        try:
            row = analyze_cell(path, link_bw=link_bw)
        except (OSError, ValueError, KeyError, TypeError) as e:
            row = {"arch": os.path.basename(path), "error": str(e)[:200]}
        if row:
            rows.append(row)
    return rows


def markdown_table(rows) -> str:
    hdr = ("| arch | shape | mesh | compute s | memory s | collective s | "
           "dominant | useful/HLO | roofline frac |")
    sep = "|" + "---|" * 9
    lines = [hdr, sep]
    for r in rows:
        if "error" in r:
            lines.append(f"| {r['arch']} | ERROR {r['error'][:60]} |" + " |" * 7)
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | {r['dominant']} "
            f"| {r['useful_flops_ratio']:.2f} | {r['roofline_fraction']:.3f} |")
    return "\n".join(lines)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun-dir", default="runs/torch/dryrun")
    ap.add_argument("--link-bw", type=float, default=LINK_BW,
                    help="bytes/s a card's links carry each way")
    ap.add_argument("--out", default="runs/torch/roofline.json")
    args = ap.parse_args(argv)
    rows = run_all(args.dryrun_dir, link_bw=args.link_bw)
    print(markdown_table(rows))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
