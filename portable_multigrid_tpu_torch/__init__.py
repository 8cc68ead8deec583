"""PyTorch / CUDA port of portable_multigrid_tpu for NVIDIA Hopper.

Matrix-free geometric (h) and polynomial (p) multigrid for Poisson, the
mixed p->h ladder and the mixed-precision solve, and geometric multigrid
for linear elasticity, on structured hyper-cube meshes with continuous Q_p
elements: CG preconditioned by a V-cycle with Chebyshev smoothing.  The hot
work runs in hand-written CUDA kernels (``csrc/``) on a CUDA device, where
the solves replay the V-cycle from a CUDA graph; every kernel wrapper runs
the kernel's plain torch twin when given CPU tensors.  This package imports
torch and NumPy only.
"""

from .models.elasticity import ElasticityMultigrid
from .models.mixed import MixedMultigridPoisson, MixedPrecisionPoisson
from .models.poisson import (
    GeometricMultigridPoisson,
    PolynomialMultigridPoisson,
    SolveStats,
)
from .solvers.cg import cg_fixed_iterations
from .solvers.refinement import iterative_refinement

__all__ = ["ElasticityMultigrid", "GeometricMultigridPoisson",
           "MixedMultigridPoisson", "MixedPrecisionPoisson",
           "PolynomialMultigridPoisson", "SolveStats", "cg_fixed_iterations",
           "iterative_refinement"]
