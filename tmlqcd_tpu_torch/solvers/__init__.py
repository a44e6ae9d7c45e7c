"""Krylov solvers, the chronological guess and the solver dispatch seam,
and the overlap's Lanczos and SUMR."""

from tmlqcd_tpu_torch.solvers.lanczos import lanczos_herm, lowest_eigenpairs  # noqa: F401
from tmlqcd_tpu_torch.solvers.sumr import sumr  # noqa: F401
