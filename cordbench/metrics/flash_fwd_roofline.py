"""The flash forward kernel's share of its roofline in the profiled
slice: the least time of the whole-prompt prefills' attention calls
(cordbench/flops.py, bf16 products) over the device time of the
operations named flash_fwd."""

from cordbench import flops


def read(run):
    prof, spans = run.get("prof"), run.get("spans")
    if prof is None or spans is None:
        return None
    m = run["m"]
    a = m["attention"]
    hd = a["head_dim"] or m["d_model"] // a["num_heads"]
    lo, hi = run["slice_rows"]
    least = 0.0
    for r in spans.rows[lo:hi]:
        if r["kind"] == "prefill":
            ops, nbytes = flops.flash_fwd(1, r["info"]["tokens"],
                                          a["num_heads"], a["num_kv_heads"],
                                          hd, window=a["sliding_window"])
            least += m["num_layers"] * flops.least_s(ops, nbytes,
                                                     flops.BF16_FLOPS)
    device_s = prof.device_us(lambda name: "flash_fwd" in name) / 1e6
    if least <= 0 or device_s <= 0:
        return None
    return 100.0 * least / device_s
