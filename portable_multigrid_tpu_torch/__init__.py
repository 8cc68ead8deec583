"""PyTorch / CUDA port of portable_multigrid_tpu for NVIDIA Hopper.

Matrix-free geometric (h) and polynomial (p) multigrid for Poisson, and
geometric multigrid for linear elasticity, on structured hyper-cube meshes
with continuous Q_p elements: CG preconditioned by a V-cycle with Chebyshev
smoothing.  The hot work runs in hand-written CUDA kernels (``csrc/``) on a
CUDA device; every kernel wrapper runs the kernel's plain torch twin when
given CPU tensors.  This package imports torch and NumPy only.
"""

from .models.elasticity import ElasticityMultigrid
from .models.poisson import (
    GeometricMultigridPoisson,
    PolynomialMultigridPoisson,
    SolveStats,
)

__all__ = ["ElasticityMultigrid", "GeometricMultigridPoisson",
           "PolynomialMultigridPoisson", "SolveStats"]
