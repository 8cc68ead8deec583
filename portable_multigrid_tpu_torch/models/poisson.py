"""Geometric-multigrid Poisson solve (torch port of the reference's first
driver).

Counterpart of ``portable_multigrid_tpu/models/poisson.py``
(``GeometricMultigridPoisson``, ``SolveStats``, ``_build_level``,
``_assemble_levels``): dim-D Poisson on the unit hyper-cube, f ≡ 1,
homogeneous Dirichlet on the whole boundary, h-multigrid over the geometric
coarsening sequence, Chebyshev(5) smoothing, V(2,2), CG to rtol * ||b||
(reference: source/geometric_multigrid/program.cc).

Variants:

  * ``"auto"`` (3D only) — the kernel path: every level above the 1-cell
    coarsest runs the B.1 operator with a fused Chebyshev smoother and the
    B.2 pair kernel on trimmed state; the coarsest level runs plain
    Chebyshev-as-solver on the B.1 operator's full-grid apply; every h-pair
    runs the B.3 transfer kernel.  One exact operator serves every role.
    On CPU tensors each kernel wrapper runs its plain twin.
  * ``"kron"`` — the plain path: the Kronecker operator, plain Chebyshev and
    the windowed ``Transfer`` on full grids.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fem.assemble import assemble_rhs, l2_norm
from ..fem.mesh import HyperCubeMesh, geometric_coarsening_sequence
from ..fem.space import FESpace
from ..ops.cuda_cheb2 import make_cheb2
from ..ops.cuda_laplace import make_cuda_laplace
from ..ops.cuda_transfer import make_cuda_h_transfer
from ..ops.laplace import make_laplace, reject_variant
from ..ops.transfer import make_h_transfer
from ..solvers.cg import cg
from ..solvers.chebyshev import make_chebyshev
from ..solvers.vcycle import MGLevel, VCycle, wire_trimmed


@dataclasses.dataclass
class SolveStats:
    iterations: int
    residual_norm: float
    converged: bool
    solution_l2_norm: float
    n_dofs: int
    dofs_per_level: list


def _build_level(space: FESpace, dtype, coarse: bool, variant: str,
                 device) -> tuple:
    if variant == "auto":
        if space.dim != 3:
            raise ValueError("variant 'auto' is 3D only; the 2D kernels are "
                             "ROADMAP A.8 / B.4")
        op = make_cuda_laplace(space, dtype, device)
    elif variant == "kron":
        op = make_laplace(space, dtype, "kron", device)
    else:
        reject_variant(variant)
    if coarse:
        smoother = make_chebyshev(op, smoothing_range=1e-3, degree=None,
                                  eig_cg_n_iterations=space.n_dofs)
    else:
        fused = variant == "auto"
        smoother = make_chebyshev(
            op, smoothing_range=15.0, degree=5, eig_cg_n_iterations=10,
            fused=fused, cheb2=make_cheb2(op) if fused else None)
    return op, smoother


class GeometricMultigridPoisson:
    """h-multigrid Poisson solve; ``refinements`` is the finest level and the
    hierarchy is the full coarsening sequence down to the 1-cell mesh."""

    def __init__(self, dim: int, degree: int, refinements: int,
                 dtype=torch.float64, variant: str = "auto", device="cpu"):
        self.dtype = dtype
        self.variant = variant
        self.device = torch.device(device)
        mesh = HyperCubeMesh(dim, refinements)
        spaces = [FESpace(m, degree) for m in geometric_coarsening_sequence(mesh)]
        self._assemble_levels(spaces)

    def _assemble_levels(self, spaces):
        levels = []
        for i, sp in enumerate(spaces):
            op, smoother = _build_level(sp, self.dtype, coarse=(i == 0),
                                        variant=self.variant,
                                        device=self.device)
            transfer = None
            if i > 0:
                if self.variant == "auto":
                    # the coarsest level keeps the full grid
                    transfer = make_cuda_h_transfer(
                        spaces[i - 1], sp, self.dtype, self.device,
                        coarse_trimmed=i - 1 > 0)
                else:
                    transfer = make_h_transfer(spaces[i - 1], sp, self.dtype,
                                               self.device)
            levels.append(MGLevel(op=op, smoother=smoother, transfer=transfer))
        levels, self.fine_trimmed = wire_trimmed(levels)
        self.spaces = list(spaces)
        self.levels = tuple(levels)

    def preconditioner(self, pre_smoothing_steps: int = 2,
                       post_smoothing_steps: int = 2) -> VCycle:
        return VCycle(levels=self.levels,
                      pre_smoothing_steps=pre_smoothing_steps,
                      post_smoothing_steps=post_smoothing_steps,
                      fine_trimmed=self.fine_trimmed)

    def rhs(self, f=None) -> torch.Tensor:
        return torch.as_tensor(assemble_rhs(self.spaces[-1], f=f),
                               dtype=self.dtype, device=self.device)

    def solve(self, rtol: float = 1e-12, pre_smoothing_steps: int = 2,
              post_smoothing_steps: int = 2, verbose: bool = False,
              f=None) -> tuple[torch.Tensor, SolveStats]:
        """Solve -Δu = f (f ≡ 1 when None, like the reference driver)."""
        fine = self.spaces[-1]
        mg = self.preconditioner(pre_smoothing_steps, post_smoothing_steps)
        result = cg(self.levels[-1].op.apply, self.rhs(f), mg.apply, rtol=rtol)
        x = result.x.detach().cpu().numpy().astype(np.float64)
        stats = SolveStats(
            iterations=result.iterations,
            residual_norm=result.residual_norm,
            converged=result.converged,
            solution_l2_norm=l2_norm(fine, x),
            n_dofs=fine.n_dofs,
            dofs_per_level=[sp.n_dofs for sp in self.spaces],
        )
        if verbose:
            print(
                f" Number of degrees of freedom: {stats.n_dofs} "
                f"(by level: {', '.join(str(d) for d in stats.dofs_per_level)})"
            )
            print(f"  Solver converged in {stats.iterations} iterations.")
            print(f"  solution norm: {stats.solution_l2_norm:.6g}")
        return result.x, stats
