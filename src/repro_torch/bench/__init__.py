"""Benchmarks of the port, each the counterpart of a ``benchmarks/``
module: ``perftest`` (paper §2 Fig. 1, §5 Figs. 3-5) over the verbs
transport, the control-plane smokes, ``converged`` (train and serve
tenants on one dataplane), ``serve`` (gang, fixed stripe and paged at
equal KV memory) and ``npb`` (the NPB suite, paper Fig. 6)."""
