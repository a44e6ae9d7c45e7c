"""Krylov solvers, the chronological guess and the solver dispatch seam."""
