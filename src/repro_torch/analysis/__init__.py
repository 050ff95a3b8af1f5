"""Program analysis: the cost counter of a ``meta``-device run
(``cost.py``), the port's counterpart of ``repro/analysis``."""
