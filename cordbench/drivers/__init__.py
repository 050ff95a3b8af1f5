"""Drivers: the loops that drive one of the port's entries through a
cell's window.  A traffic mix names its driver (`"driver"`); each driver
has `run(ctx)` and declares its `KIND`, `"serve"` or `"train"`, which
says what `calibrate.py` reads and which faults it plants."""
