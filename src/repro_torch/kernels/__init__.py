"""Kernels written by hand for Hopper (CUDA C++ for ``sm_90a``), each with
a plain PyTorch version beside it that its wrapper uses for CPU tensors."""
