"""Serving launcher: batched requests through the Engine.

``python -m repro_torch.launch.serve --arch gemma3-1b --requests 8
[--scheduler continuous|gang] [--block-size 16] [--n-blocks N]
[--prefill-chunk 512] [--device cuda|cpu]``

``--arch`` takes a dense model (gemma3, granite) or hymba-1.5b, the
hybrid family, which the engine prefills at exact prompt length.  The
flags are ``repro.launch.serve``'s.  ``--block-size > 0`` serves from the
paged KV block pool (``--n-blocks`` usable blocks, 0 = the stripes' token
capacity; a dense model only: hymba raises
:class:`~repro_torch.serve.ServeError`).  ``--prefill-chunk`` prefills a
dense model's prompts longer than one chunk a chunk per engine tick (0
prefills whole prompts).  ``--timeline`` and ``--elastic`` belong to later
slices of the port and raise :class:`~repro_torch.serve.ServeError`.
"""

import argparse
import time

import numpy as np

from repro_torch.configs import get_model_config
from repro_torch.configs.base import ServeConfig
from repro_torch.models import build_model
from repro_torch.serve import Engine, Request, ServeError, prompt_bucket


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--scheduler", default="continuous",
                    choices=("continuous", "gang"))
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--block-size", type=int, default=0,
                    help="paged KV: pool block size in tokens (0 = fixed "
                         "stripes)")
    ap.add_argument("--n-blocks", type=int, default=0,
                    help="paged KV: usable pool blocks (0 = auto: the "
                         "stripe layout's token capacity)")
    ap.add_argument("--prefill-chunk", type=int, default=512,
                    help="chunked prefill: tokens per prefill tick (power "
                         "of two >= 8; 0 disables chunking)")
    ap.add_argument("--timeline", action="store_true",
                    help="per-tick timelines (ported in a later slice)")
    ap.add_argument("--elastic", action="store_true",
                    help="serve-side elastic control (ported in a later "
                         "slice)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("overrides", nargs="*", default=[],
                    help="elastic.* key=value overrides")
    args = ap.parse_args(argv)
    if args.timeline or args.elastic:
        raise ServeError("--timeline / --elastic are ported with the "
                         "timelines and control-plane slices")

    cfg = get_model_config(args.arch, smoke=True)
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    kv_len = max(prompt_bucket(10) + args.max_new_tokens + 1, 128)
    if args.block_size > 0:
        kv_len = -(-kv_len // args.block_size) * args.block_size
    eng = Engine(model, params, cfg,
                 ServeConfig(max_batch=args.max_batch,
                             max_new_tokens=args.max_new_tokens,
                             kv_cache_len=kv_len,
                             scheduler=args.scheduler,
                             block_size=args.block_size,
                             n_blocks=args.n_blocks,
                             prefill_chunk=args.prefill_chunk),
                 eos_id=-1)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, 6 + i % 5),
                    max_new_tokens=args.max_new_tokens)
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = eng.run(reqs)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in done)
    ttft = [r.t_first - t0 for r in done if r.t_first is not None]
    print(f"served {len(done)} requests, {toks} tokens "
          f"in {dt:.2f}s ({toks/dt:.1f} tok/s, {args.scheduler} scheduler, "
          f"{eng.decode_compile_count()} decode shapes, "
          f"mean TTFT {1e3*sum(ttft)/max(len(ttft),1):.0f} ms, "
          f"device {model.device})")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.out_tokens[:8]}...")
    for tenant, stats in eng.tenant_report().items():
        print(f"  tenant {tenant}: {stats}")


if __name__ == "__main__":
    main()
