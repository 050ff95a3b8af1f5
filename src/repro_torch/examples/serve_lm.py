"""Serve a small LM with batched requests through the engine; the port
of ``examples/serve_lm.py``.

    python -m repro_torch.examples.serve_lm [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_model_config
from repro_torch.configs.base import ServeConfig
from repro_torch.models import build_model
from repro_torch.serve import Engine, Request


def run(model, params) -> dict:
    """Serve the example's 10 requests (prompts from
    ``np.random.default_rng(0)``) over 4 slots; returns the finished
    requests and the rate."""
    eng = Engine(model, params, model.cfg,
                 ServeConfig(max_batch=4, max_new_tokens=16), eos_id=-1)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, 250, 5 + i % 7),
                    max_new_tokens=16) for i in range(10)]
    t0 = time.perf_counter()
    done = eng.run(reqs)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"{len(done)} requests, {toks} tokens in {dt:.2f}s "
          f"({toks/dt:.1f} tok/s, continuous batching over 4 slots)")
    for r in done[:4]:
        print(f"  req {r.rid} ({len(r.prompt)} prompt toks): "
              f"{r.out_tokens}")
    return {"done": done, "tokens": toks, "tok_s": toks / dt}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    cfg = get_model_config("gemma3-1b", smoke=True)
    model = build_model(cfg, device=args.device)
    return run(model, model.init(0))


if __name__ == "__main__":
    main()
