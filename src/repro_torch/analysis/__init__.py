"""Program analysis: the cost counter of a ``meta``-device run
(``cost.py``) and the roofline over the dry run's cells
(``roofline.py``), the port's counterparts of ``repro/analysis`` and
``benchmarks/roofline.py``."""
