"""Benchmarks of the port: ``perftest`` (paper §2 Fig. 1, §5 Figs. 3-5)
over the verbs transport."""
