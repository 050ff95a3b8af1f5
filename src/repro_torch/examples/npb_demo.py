"""Paper Fig. 6 in miniature: the NPB suite under bypass / cord / socket;
the port of ``examples/npb_demo.py``.

    python -m repro_torch.examples.npb_demo [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.bench import npb


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    rows = npb.run_all(benches=("EP", "CG", "FT"), device=args.device)
    print(f"{'bench':6s} {'mode':8s} {'ms':>9s} {'rel':>7s}")
    for r in rows:
        print(f"{r['bench']:6s} {r['mode']:8s} {r['ms']:9.2f} "
              f"{r['rel_runtime']:7.3f}")
    print("\npaper claim: cord ≈ bypass everywhere; socket (IPoIB) up to "
          "2× slower on comm-heavy kernels")
    return rows


if __name__ == "__main__":
    main()
