"""Plain PyTorch references of the cells' models, in float32 with TF32 off.

They import nothing of the program and read only what the benchmark made
(weights from `cordbench/weights.py`, tokens from the traffic generator)
and the program's outputs that they judge.  `Precision("fp8")` computes
every matrix product from float8 (e4m3) operands: the lower precision
that the correctness check's control uses.
"""
