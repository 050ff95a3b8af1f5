"""The examples of ``examples/`` as modules of the port: each runs as
``python -m repro_torch.examples.<name> [--device cpu]`` with the JAX
example's sizes, arguments and printed lines, and has a ``run(...)``
that takes its model and parameters (or its device), so that a test can
hand it parameters converted from ``repro``."""
