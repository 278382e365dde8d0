"""LINVIEW on PyTorch and CUDA: the port of :mod:`repro` to the H100.

Subpackages mirror the JAX package's layout — ``core`` (symbolic compiler,
codegen, engines), ``kernels`` (hand-written CUDA kernels and their plain
PyTorch versions), ``apps`` and ``data``.  The port imports neither JAX
nor the JAX package.
"""
