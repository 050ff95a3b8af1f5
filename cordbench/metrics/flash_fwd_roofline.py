"""The flash forward kernel's share of its roofline in the profiled
slice: the least time of the whole-prompt prefills' attention calls, one
a layer with attention under that layer's window (cordbench/flops.py,
bf16 products), over the device time of the operations named
flash_fwd."""

from cordbench import cells, flops


def read(run):
    prof, spans = run.get("prof"), run.get("spans")
    if prof is None or spans is None:
        return None
    m = run["m"]
    a = m["attention"]
    windows = cells.family(m["family"]).attention_windows(m)
    lo, hi = run["slice_rows"]
    least = 0.0
    for r in spans.rows[lo:hi]:
        if r["kind"] == "prefill":
            call = 0.0
            for w in windows:
                ops, nbytes = flops.flash_fwd(1, r["info"]["tokens"],
                                              a["num_heads"],
                                              a["num_kv_heads"],
                                              flops.head_dim(m), window=w)
                call += flops.least_s(ops, nbytes, flops.BF16_FLOPS)
            least += call
    device_s = prof.device_us(lambda name: "flash_fwd" in name) / 1e6
    if least <= 0 or device_s <= 0:
        return None
    return 100.0 * least / device_s
