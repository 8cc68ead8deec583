"""Poisson model problems: the reference's two drivers (torch port).

Counterpart of ``portable_multigrid_tpu/models/poisson.py``
(``SolveStats``, ``_build_level``, ``_MultigridPoissonBase`` as
``_MultigridBase``,
``GeometricMultigridPoisson``, ``PolynomialMultigridPoisson``): dim-D
Poisson on the unit hyper-cube, f ≡ 1, homogeneous Dirichlet on the whole
boundary, Chebyshev(5) smoothing, V(2,2), CG to rtol * ||b||, over

  * the geometric coarsening sequence, equal degree (h-multigrid;
    reference: source/geometric_multigrid/program.cc), or
  * one mesh with the polynomial ladder p_l = p - (L-1-l) (p-multigrid;
    reference: source/polynomial_multigrid/program.cc:149-159).

Variants:

  * ``"auto"`` — the kernel path: every level runs the kernel operator
    (B.1 in 3D, B.4 in 2D) with a fused Chebyshev smoother on trimmed
    state, each recurrence step one pass of the kernel; the levels above
    the coarsest add the B.2 pair kernel in 3D (the JAX package has none
    in 2D).  The coarsest level's Chebyshev-as-solver runs at the exact
    grade in the operator's dtype, without pairs or bf16 state (the JAX
    package runs it plain, on the full grid).  3D h-pairs run the B.3
    transfer kernel, every other pair the plain ``Transfer``.  On a
    float32 smoothing level the smoother runs the JAX package's production
    grade (``portable_multigrid_tpu/models/poisson.py:46-131``): the exact
    operator for CG, the eigenvalue estimate and the level residuals, the
    recurrence on a bf16-grade operator (B.1's ``"mxu"`` core and B.2 at
    its production grade in 3D; the exact B.4 in 2D), with r and d stored
    in bfloat16 between passes.  float64 levels run the exact operator in
    every role.  ``PMG_CHEB2=0`` drops the B.2 pairs (every recurrence step
    a B.1 pass); ``PMG_CHEB2R=1`` adds B.2's ``cheb2lr`` kernel, so that
    the last pre-smoothing pair also gives the residual to restrict, on
    every level where its tile fits (p <= 5 in float32, p <= 3 in float64;
    the JAX package builds it where it compiles): the switches and defaults
    of ``portable_multigrid_tpu/models/poisson.py:96-114``.  On CPU tensors
    each kernel wrapper runs its plain twin.
  * ``"kron"``, ``"sumfac"``, ``"dense"`` — the plain paths: the operator
    variant of ``ops/laplace.py``, plain Chebyshev and the windowed
    ``Transfer`` on full grids.

With ``coefficient=`` (:class:`GeometricMultigridPoisson`; a callable c(x)
of dim coordinate arrays) the problem is -div(c grad u) = f: every level
rediscretizes the same coefficient on the operator variant that
``PMG_VARCOEFF_VARIANT`` names (default ``"qdense"``, or ``"sumfac"`` or
``"qbanded"``), whatever the model's variant, with plain Chebyshev and
plain transfers on full grids, as in the JAX package.

On a CUDA device :meth:`_MultigridBase.solve` replays the V-cycle from a
CUDA graph (``solvers/vcycle.py`` ``GraphedVCycle``), the counterpart of the
JAX package's jitted solve; CG reads the residual norm on the host once an
iteration.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..fem.assemble import assemble_rhs, l2_norm
from ..fem.mesh import HyperCubeMesh, geometric_coarsening_sequence
from ..fem.space import FESpace
from ..ops.cuda_cheb2 import cheb2_fits, make_cheb2
from ..ops.cuda_laplace import CudaLaplaceOperator, make_cuda_laplace
from ..ops.cuda_laplace2d import make_cuda_laplace2d
from ..ops.cuda_transfer import make_cuda_h_transfer
from ..ops.laplace import make_laplace
from ..ops.transfer import make_h_transfer, make_p_transfer
from ..solvers.cg import cg
from ..solvers.chebyshev import make_chebyshev
from ..solvers.vcycle import GraphedVCycle, MGLevel, VCycle, wire_trimmed


@dataclasses.dataclass
class SolveStats:
    iterations: int
    residual_norm: float
    converged: bool
    solution_l2_norm: float
    n_dofs: int
    dofs_per_level: list


def _build_level(space: FESpace, dtype, coarse: bool, variant: str,
                 device, coefficient=None) -> tuple:
    if coefficient is not None:
        # coarse levels rediscretize the same coefficient
        op = make_laplace(space, dtype,
                          os.environ.get("PMG_VARCOEFF_VARIANT", "qdense"),
                          device, coefficient=coefficient)
    elif variant == "auto":
        make_op = {2: make_cuda_laplace2d, 3: make_cuda_laplace}.get(space.dim)
        if make_op is None:
            raise ValueError("variant 'auto' runs 2D and 3D spaces only")
        op = make_op(space, dtype, device)
    else:
        op = make_laplace(space, dtype, variant, device)
    # the kernel operators smooth fused, on trimmed state
    fused = isinstance(op, CudaLaplaceOperator)
    if coarse:
        # Chebyshev as solver: on a kernel operator every recurrence step
        # is one pass of its kernel, at the exact grade in its dtype
        smoother = make_chebyshev(op, smoothing_range=1e-3, degree=None,
                                  eig_cg_n_iterations=space.n_dofs,
                                  fused=fused)
    else:
        # in float32 the recurrence runs at the JAX package's bf16 grade
        grade = fused and dtype == torch.float32
        smooth_op = None
        if grade:
            smooth_op = (make_cuda_laplace(space, dtype, device, core="mxu")
                         if space.dim == 3 else op)
        pair_op = op if smooth_op is None else smooth_op
        pair = pair_r = None
        if (fused and op.pair_kernel
                and os.environ.get("PMG_CHEB2", "1") == "1"):
            pair = make_cheb2(pair_op)
            # opt-in, as in the JAX package: the residual then comes at the
            # recurrence's grade, which costs at most one CG iteration
            if (os.environ.get("PMG_CHEB2R", "0") == "1"
                    and cheb2_fits(pair_op, rout=True)):
                pair_r = make_cheb2(pair_op, rout=True)
        smoother = make_chebyshev(
            op, smoothing_range=15.0, degree=5, eig_cg_n_iterations=10,
            fused=fused, cheb2=pair, fused_smoother_op=smooth_op,
            state_dtype=torch.bfloat16 if grade else None, cheb2r=pair_r)
    return op, smoother


def build_untrimmed_vcycle(spaces, dtype=torch.float32,
                           device="cuda") -> VCycle:
    """The V-cycle that the JAX package's ``bench.py`` builds with
    ``PMG_BENCH_TRIMMED=0`` (``bench.py:240-330``), over 3D ``spaces``
    (coarse first, one refinement apart, equal degree): the coarsest level
    as :class:`GeometricMultigridPoisson` builds it, its solver taking and
    returning full grids; every other level B.1
    with a full-grid fused smoother (``FusedChebyshev(trimmed_io=False)``:
    each smoothing step starts from one pass of B.1's untrimmed
    ``residual``), whose recurrence runs in float32 at the JAX package's
    bf16 grade (B.1's ``"mxu"`` core, r and d in bfloat16) and in float64
    on the exact operator, without B.2 pairs; the plain h-transfers on full
    grids.  No level is trimmed, so the V-cycle takes and returns full
    grids; CG runs on ``levels[-1].op``."""
    levels = []
    for i, sp in enumerate(spaces):
        if sp.dim != 3:
            raise ValueError("the untrimmed V-cycle runs B.1, in 3D")
        if i == 0:
            op, smoother = _build_level(sp, dtype, True, "auto", device)
            levels.append(MGLevel(op=op, smoother=dataclasses.replace(
                smoother, trimmed_io=False)))
            continue
        op = make_cuda_laplace(sp, dtype, device)
        grade = dtype == torch.float32
        smoother = make_chebyshev(
            op, smoothing_range=15.0, degree=5, eig_cg_n_iterations=10,
            fused_smoother_op=(make_cuda_laplace(sp, dtype, device,
                                                 core="mxu")
                               if grade else None),
            state_dtype=torch.bfloat16 if grade else None, fused=True,
            trimmed_io=False)
        levels.append(MGLevel(op=op, smoother=smoother,
                              transfer=make_h_transfer(spaces[i - 1], sp,
                                                       dtype, device)))
    levels, fine_trimmed = wire_trimmed(levels)
    return VCycle(levels=tuple(levels), pre_smoothing_steps=2,
                  post_smoothing_steps=2, fine_trimmed=fine_trimmed)


class _MultigridBase:
    """Common machinery: build levels, solve, report.  A model of a
    vector-valued field sets ``components`` and supplies its own
    :meth:`_build_level` and :meth:`rhs` (``models/elasticity.py``)."""

    components = 1  # field components per DoF grid point
    # dtype of CG's vectors where it differs from the levels'
    # (models/mixed.py MixedPrecisionPoisson); the V-cycle casts at its ends
    io_dtype = None

    def __init__(self, dtype=torch.float64, variant: str = "auto",
                 device="cuda", coefficient=None):
        self.dtype = dtype
        self.variant = variant
        self.device = torch.device(device)
        self.coefficient = coefficient
        self._graphed = {}  # GraphedVCycle by (pre, post) smoothing steps

    def _build_level(self, space: FESpace, coarse: bool) -> tuple:
        return _build_level(space, self.dtype, coarse, self.variant,
                            self.device, self.coefficient)

    def _assemble_levels(self, spaces, kinds):
        """Levels over ``spaces`` (coarse first), ``kinds[i]`` the transfer
        between spaces i and i+1: "h" (one refinement, equal degree) or
        "p" (one mesh, higher degree)."""
        levels = []
        prev_trimmed = False
        for i, sp in enumerate(spaces):
            op, smoother = self._build_level(sp, coarse=(i == 0))
            # what the level is, not the model's variant, picks the transfer
            trimmed = bool(getattr(smoother, "trimmed_io", False))
            transfer = None
            if i > 0:
                kind = kinds[i - 1]
                if trimmed and sp.dim == 3 and kind == "h":
                    transfer = make_cuda_h_transfer(
                        spaces[i - 1], sp, self.dtype, self.device,
                        coarse_trimmed=prev_trimmed)
                else:
                    # wire_trimmed adapts it to trimmed levels
                    make = {"h": make_h_transfer, "p": make_p_transfer}[kind]
                    transfer = make(spaces[i - 1], sp, self.dtype, self.device)
            prev_trimmed = trimmed
            levels.append(MGLevel(op=op, smoother=smoother, transfer=transfer))
        levels, self.fine_trimmed = wire_trimmed(levels)
        self.spaces = list(spaces)
        self.levels = tuple(levels)

    @property
    def fine_operator(self):
        """The operator CG runs on."""
        return self.levels[-1].op

    def preconditioner(self, pre_smoothing_steps: int = 2,
                       post_smoothing_steps: int = 2, graph: bool = True):
        """The V-cycle: on a CUDA device the model's
        :class:`GraphedVCycle` (one per pair of step counts, kept with its
        graphs for later solves) unless ``graph`` is False; the eager
        :class:`VCycle` otherwise, and always on the CPU."""
        mg = VCycle(levels=self.levels,
                    pre_smoothing_steps=pre_smoothing_steps,
                    post_smoothing_steps=post_smoothing_steps,
                    fine_trimmed=self.fine_trimmed, io_dtype=self.io_dtype)
        if not graph or self.device.type != "cuda":
            return mg
        key = (pre_smoothing_steps, post_smoothing_steps)
        if key not in self._graphed:
            self._graphed[key] = GraphedVCycle(mg)
        return self._graphed[key]

    def rhs(self, f=None) -> torch.Tensor:
        return torch.as_tensor(assemble_rhs(self.spaces[-1], f=f),
                               dtype=self.io_dtype or self.dtype,
                               device=self.device)

    def solution_l2_norm(self, x: np.ndarray) -> float:
        """L2 norm of a fine-level solution: sqrt(sum_c ||x_c||^2) for a
        vector field."""
        fine = self.spaces[-1]
        if self.components == 1:
            return l2_norm(fine, x)
        return float(np.sqrt(sum(l2_norm(fine, xc) ** 2 for xc in x)))

    def solve(self, rtol: float = 1e-12, pre_smoothing_steps: int = 2,
              post_smoothing_steps: int = 2, verbose: bool = False,
              f=None, graph: bool = True) -> tuple[torch.Tensor, SolveStats]:
        """Solve with right-hand side f (f ≡ 1 when None, as in the
        reference program); ``graph=False`` runs the V-cycle eagerly on a
        CUDA device."""
        mg = self.preconditioner(pre_smoothing_steps, post_smoothing_steps,
                                 graph)
        result = cg(self.fine_operator.apply, self.rhs(f), mg.apply,
                    rtol=rtol)
        fine = self.spaces[-1]
        x = result.x.detach().cpu().numpy().astype(np.float64)
        stats = SolveStats(
            iterations=result.iterations,
            residual_norm=result.residual_norm,
            converged=result.converged,
            solution_l2_norm=self.solution_l2_norm(x),
            n_dofs=self.components * fine.n_dofs,
            dofs_per_level=[self.components * sp.n_dofs for sp in self.spaces],
        )
        if verbose:
            print(
                f" Number of degrees of freedom: {stats.n_dofs} "
                f"(by level: {', '.join(str(d) for d in stats.dofs_per_level)})"
            )
            print(f"  Solver converged in {stats.iterations} iterations.")
            print(f"  solution norm: {stats.solution_l2_norm:.6g}")
        return result.x, stats


class GeometricMultigridPoisson(_MultigridBase):
    """h-multigrid Poisson solve; ``refinements`` is the finest level and the
    hierarchy is the full coarsening sequence down to the 1-cell mesh.
    ``coefficient`` (a callable c(x)) makes it -div(c grad u) = f."""

    def __init__(self, dim: int, degree: int, refinements: int,
                 dtype=torch.float64, variant: str = "auto", device="cuda",
                 coefficient=None):
        super().__init__(dtype, variant, device, coefficient)
        mesh = HyperCubeMesh(dim, refinements)
        spaces = [FESpace(m, degree) for m in geometric_coarsening_sequence(mesh)]
        self._assemble_levels(spaces, "h" * (len(spaces) - 1))


class PolynomialMultigridPoisson(_MultigridBase):
    """p-multigrid Poisson solve on one mesh; degrees
    p_l = degree - (n_levels-1-l) (reference:
    source/polynomial_multigrid/program.cc:149-159)."""

    def __init__(self, dim: int, degree: int, refinements: int,
                 n_levels: int | None = None, dtype=torch.float64,
                 variant: str = "auto", device="cuda"):
        super().__init__(dtype, variant, device)
        if n_levels is None:
            n_levels = degree
        if n_levels > degree:
            raise ValueError("n_levels must be <= degree")
        mesh = HyperCubeMesh(dim, refinements)
        degrees = [degree - (n_levels - 1 - l) for l in range(n_levels)]
        self._assemble_levels([FESpace(mesh, p) for p in degrees],
                              "p" * (n_levels - 1))
