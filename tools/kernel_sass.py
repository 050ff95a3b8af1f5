#!/usr/bin/env python3
"""What nvcc made of a kernel source: registers, spills and shared memory
of each kernel, its SASS by opcode, and the instructions of small probes.

    python3 tools/kernel_sass.py [--root CHECKOUT] [--source ssm_scan]
        [--match ssm_bwd] [--probe NAME=EXPR ...] [--out sass.txt]

It compiles ``--source`` (a name of ``repro_torch.kernels.build.SOURCES``)
of ``--root`` (a checkout of this repository, by default this one) with
the build's own flags and ``-Xptxas -v`` into a cubin, prints the
ptxas lines of every kernel whose name holds ``--match``, and counts the
SASS instructions of those kernels by opcode (``cuobjdump -sass``; the
whole listing goes to ``--out``).  Each ``--probe NAME=EXPR`` is a kernel
``y[i] = EXPR`` of one double ``v = x[i]``, compiled in one unit with the
source (so EXPR may call its device functions); a probe's count is its
instructions less those of ``y[i] = v``.  ``exp(v)``, libdevice's float64
exponential, is always probed.  It needs the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import re
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _sass_functions(listing: str) -> dict[str, list[str]]:
    """Function name -> its SASS opcodes, in order."""
    funcs: dict[str, list[str]] = {}
    cur = None
    for line in listing.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                     line)
        if cur is not None and m:
            cur.append(m.group(2))
    return funcs


def _demangle(names: list[str], bindir: pathlib.Path) -> dict[str, str]:
    for tool in (str(bindir / "cu++filt"), "c++filt"):
        try:
            out = subprocess.run([tool], input="\n".join(names),
                                 capture_output=True, text=True, timeout=60)
        except OSError:
            continue
        if out.returncode == 0:
            return dict(zip(names, out.stdout.splitlines()))
    return {n: n for n in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--source", default="ssm_scan")
    ap.add_argument("--match", default="ssm_bwd")
    ap.add_argument("--probe", action="append", default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build

    src = pathlib.Path(args.root).resolve() / "src" / "repro_torch" / \
        build.SOURCES[args.source]
    probes = {"libdevice_exp": "exp(v)"}
    for p in args.probe:
        name, expr = p.split("=", 1)
        probes[name] = expr
    bindir = pathlib.Path(build._nvcc()).parent
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                      "-fPIC")]
    with tempfile.TemporaryDirectory(prefix="kernel_sass_") as tmp:
        unit = pathlib.Path(tmp) / "unit.cu"
        body = [f'#include "{src}"',
                'extern "C" __global__ void probe_empty(const double* x, '
                'double* y) { const double v = x[threadIdx.x]; '
                'y[threadIdx.x] = v; }']
        body += [f'extern "C" __global__ void probe_{name}(const double* x, '
                 f'double* y) {{ const double v = x[threadIdx.x]; '
                 f'y[threadIdx.x] = {expr}; }}' for name, expr in probes.items()]
        unit.write_text("\n".join(body) + "\n")
        cubin = pathlib.Path(tmp) / "unit.cubin"
        r = subprocess.run([build._nvcc(), *flags, "-cubin", "-Xptxas", "-v",
                            "-o", str(cubin), str(unit)],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout + r.stderr, file=sys.stderr)
            return 1
        listing = subprocess.run(
            [str(bindir / "cuobjdump"), "-sass",
             str(cubin)], capture_output=True, text=True, check=True,
            timeout=300).stdout
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(listing)
    log = (r.stdout + r.stderr).splitlines()
    funcs = _sass_functions(listing)
    names = _demangle(list(funcs), bindir)
    for i, line in enumerate(log):       # ptxas: the entry, then its lines
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m and (args.match in names.get(m.group(1), m.group(1))
                  or m.group(1).startswith("probe_")):
            print(names.get(m.group(1), m.group(1)))
            for nxt in log[i + 1:i + 5]:
                if "Compiling entry" in nxt:
                    break
                print("   ", nxt.split("info    :")[-1].strip())
    base = len(funcs.get("probe_empty", []))
    for fn, ops in funcs.items():
        count = collections.Counter(op.split(".")[0] for op in ops)
        if fn.startswith("probe_") and fn != "probe_empty":
            print(f"{fn}: {len(ops) - base} SASS instructions more than "
                  f"y = v; {dict(count.most_common(10))}")
        elif args.match in names[fn]:
            print(f"{names[fn]}: {len(ops)} SASS instructions; "
                  + ", ".join(f"{k} {v}" for k, v in count.most_common(24)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
