"""Drivers: the loops that drive one of the port's entries through a
cell's window.  A traffic mix names its driver (`"driver"`)."""
