"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their wrappers,
and the plain PyTorch versions they are held against (``ref``)."""
