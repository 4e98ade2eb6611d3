"""Sparseloop in PyTorch: the port of the ``repro`` package (JAX on a TPU)
to PyTorch and CUDA on an NVIDIA H100.

The package mirrors ``repro``'s layout (``core``, ``obs``, ``kernels``,
``fleet``) and imports nothing of it: the framework-free modules are
copied, the batched engine is rewritten over torch tensors, and the
Pallas kernels are rewritten by hand in CUDA C++.  Entry points run on
the CUDA card unless the caller passes ``device="cpu"``.
"""
