"""PyTorch / CUDA port of portable_multigrid_tpu for NVIDIA Hopper.

Matrix-free geometric (h) and polynomial (p) multigrid for Poisson, the
mixed p->h ladder and the mixed-precision solve, and geometric multigrid
for linear elasticity, on structured hyper-cube meshes with continuous Q_p
elements, and h-multigrid Poisson on general geometry (deformed, curved
and fully unstructured hex/quad meshes): CG preconditioned by a V-cycle
with Chebyshev smoothing.  The hot work of the structured path runs in
hand-written CUDA kernels (``csrc/``) on a CUDA device, where the solves
replay the V-cycle from a CUDA graph; every kernel wrapper runs the
kernel's plain torch twin when given CPU tensors.  The general-geometry
path is plain torch, as the JAX package's is plain XLA.  This package
imports torch and NumPy only, and importing it builds nothing: the CUDA
kernels and the native DoF enumerator build at first use.

``__all__`` holds every name of the JAX package's ``__all__``, each an
object of this package.
"""

from .fem.mesh import HyperCubeMesh, geometric_coarsening_sequence
from .fem.space import FESpace
from .fem.assemble import assemble_rhs, dense_operator, l2_norm
from .ops.laplace import LaplaceOperator, make_laplace
from .ops.transfer import Transfer, make_h_transfer, make_p_transfer
from .solvers.cg import cg, cg_fixed_iterations
from .solvers.chebyshev import Chebyshev, make_chebyshev
from .solvers.vcycle import MGLevel, VCycle
from .models.poisson import (
    GeometricMultigridPoisson,
    PolynomialMultigridPoisson,
    SolveStats,
)
from .models.mixed import MixedMultigridPoisson, MixedPrecisionPoisson
from .models.general_geometry import GeneralGeometryMultigrid
from .models.elasticity import ElasticityMultigrid
from .ops.elasticity import ElasticityOperator, make_elasticity
from .ops.indexed import (
    IndexedLaplaceOperator,
    make_indexed_laplace,
    make_unstructured_laplace,
)
from .fem.general_mesh import GeneralMesh, perturbed_cube_mesh
from .solvers.refinement import iterative_refinement

__all__ = [
    "HyperCubeMesh",
    "geometric_coarsening_sequence",
    "FESpace",
    "assemble_rhs",
    "dense_operator",
    "l2_norm",
    "LaplaceOperator",
    "make_laplace",
    "Transfer",
    "make_h_transfer",
    "make_p_transfer",
    "cg",
    "cg_fixed_iterations",
    "Chebyshev",
    "make_chebyshev",
    "MGLevel",
    "VCycle",
    "GeometricMultigridPoisson",
    "PolynomialMultigridPoisson",
    "MixedMultigridPoisson",
    "GeneralGeometryMultigrid",
    "MixedPrecisionPoisson",
    "ElasticityMultigrid",
    "ElasticityOperator",
    "make_elasticity",
    "IndexedLaplaceOperator",
    "make_indexed_laplace",
    "make_unstructured_laplace",
    "GeneralMesh",
    "perturbed_cube_mesh",
    "SolveStats",
    "iterative_refinement",
]
