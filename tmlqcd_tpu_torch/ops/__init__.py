"""Operators: the plain Dirac operator, the CUDA hopping kernels and the
split fast path, the clover term, the doublet, the overlap operator
(`ops.overlap`) and the Schrödinger functional (`ops.sf`).  The package
exports modules only: the reference's function exports would shadow the
module `gauge_action` with the function of that name."""
