"""CoRD in PyTorch: the port of ``repro`` (JAX/TPU) to PyTorch and CUDA on
an NVIDIA H100.  It mirrors ``repro``'s layout and never imports JAX or
``repro``; the tests hold each module against its JAX counterpart."""
