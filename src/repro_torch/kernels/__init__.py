"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), their ctypes
wrappers, and their plain PyTorch versions (``ref.py``)."""
