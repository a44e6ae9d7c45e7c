"""Operators: the plain Dirac operator, the CUDA hopping kernels and the split fast path."""
