"""tmlqcd_tpu_torch — the PyTorch / CUDA port of the tmlqcd_tpu lattice-QCD engine.

The package mirrors the module names of the JAX package `tmlqcd_tpu`, which
stays beside it as the reference.  Plain tensor code is PyTorch; the stencil
kernels (the even/odd hopping with its fused epilogues, its multi-RHS form,
the gauge-cotangent force kernel and the slab kernels of the domain
decomposition) are hand-written CUDA C++ for Hopper (`csrc/`, bound in
`ops/dslash_cuda.py`).

Device rule: the device of the tensors decides.  A CUDA tensor reaches the
CUDA kernel or raises; a CPU tensor takes the kernel's plain PyTorch version.
There is no environment switch between the two.

Layouts follow the reference at every public function, so the two packages
can be compared array by array (numpy is the bridge, see `bridge.py`):

    spinor (packed e/o) : complex [4, 3, T, X, M]        M = Y * Z/2
    spinor (split)      : f32     [2, 4, 3, T, X, M]     re/im leading
    gauge  (full)       : complex [3, 3, 4, T, X, Y*Z]
    gauge copy (split)  : f32     [2, 8, 3|2, 3, T, X, M]

Precision follows the reference too: f32 fields, f64 accumulation in CG
norms, pseudofermion actions and ΔH.
"""

__version__ = "0.1.0"

from tmlqcd_tpu_torch.lattice import Lattice  # noqa: E402,F401
