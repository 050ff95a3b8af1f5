"""Hand-written Hopper kernels (CUDA C++ for sm_90a) with plain PyTorch
versions for CPU tensors; ``build.py`` compiles and loads them."""
