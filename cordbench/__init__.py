"""The port's benchmark: cells of `BENCHMARK.json` run through `repro_torch`.

`python3 cordbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell once; `cordbench/README.md` says how a
configuration, a traffic mix or a per-layer metric is added as files.
Nothing here imports `jax` or the JAX package.
"""
