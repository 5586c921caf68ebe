"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``), their plain PyTorch
versions (``ref.py``) and the host-side table layouts they share."""
