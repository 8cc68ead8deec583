"""Linear elasticity model problem: geometric multigrid, vector Q_p elements
(torch port).

Counterpart of ``portable_multigrid_tpu/models/elasticity.py``
(``ElasticityMultigrid``), BASELINE config 4: -div sigma(u) = f on
the unit hyper-cube with homogeneous Dirichlet everywhere, f = (1, ..., 1),
solved by CG to rtol * ||b|| with a geometric V(2,2) preconditioner over the
full coarsening sequence — Chebyshev(5), range 15, 10 eig-CG iterations on
the smoothing levels, Chebyshev-as-solver on the 1-cell level — the
skeleton of the Poisson solves on vector-valued fields.

Variants:

  * ``"auto"`` — the kernel path where B.5 applies, 3D: every level above
    the coarsest runs B.5 (``ops/cuda_elasticity.py``) with the fused
    smoother on trimmed state; the coarsest runs plain Chebyshev-as-solver
    on B.5's full-grid apply; the h-pairs run B.3 on all components in
    one launch.  In float32 the smoothing levels run the JAX package's
    smoother grade (``_maybe_mxu_recurrence``,
    ``portable_multigrid_tpu/models/elasticity.py:94-149``): the exact B.5
    for CG, the eigenvalue estimates and the residuals, the Chebyshev
    recurrence on B.5's bf16 ``"mxu"`` core; ``PMG_ELASTICITY_MXU=0``
    keeps the recurrence exact and ``PMG_ELASTICITY_FUSED=0`` runs it as
    the plain full-grid ``Chebyshev``, as there.  In float64 one operator
    serves every role of a level.  In 2D, where B.5 does not
    apply, every level falls back to ``"kron"``, as the JAX package's
    ``make_elasticity_auto`` does.  (The JAX package also falls back for
    float64, which its kernel does not take; the port's B.5 has float64
    instances, so a float64 3D ``"auto"`` solve runs them.)  On CPU
    tensors each wrapper runs its plain twin.
  * ``"kron"``, ``"sumfac"``, ``"dense"`` — the plain paths, 2D and 3D: the
    operator variant of ``ops/elasticity.py``, plain Chebyshev and the
    windowed ``Transfer`` on full grids.

``variant=None`` takes ``PMG_ELASTICITY_VARIANT``, by default ``"auto"``
for a 3D float32 solve on a CUDA device and ``"kron"`` otherwise, the JAX
package's rule (its ``"auto"`` falls back to kron outside 3D).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..fem.assemble import assemble_rhs
from ..fem.mesh import HyperCubeMesh, geometric_coarsening_sequence
from ..fem.space import FESpace
from ..ops.cuda_elasticity import make_cuda_elasticity
from ..ops.elasticity import make_elasticity
from ..solvers.chebyshev import make_chebyshev
from .poisson import _MultigridBase


class ElasticityMultigrid(_MultigridBase):
    """h-multigrid elasticity solve on the unit hyper-cube; ``refinements``
    is the finest level and the hierarchy runs down to the 1-cell mesh."""

    def __init__(self, dim: int, degree: int, refinements: int,
                 mu: float = 1.0, lam: float = 1.0, dtype=torch.float64,
                 variant: str | None = None, device="cuda"):
        if variant is None:
            default = ("auto" if dtype == torch.float32 and dim == 3
                       and torch.device(device).type == "cuda" else "kron")
            variant = os.environ.get("PMG_ELASTICITY_VARIANT", default)
        super().__init__(dtype, variant, device)
        self.mu, self.lam = float(mu), float(lam)
        self.components = dim
        mesh = HyperCubeMesh(dim, refinements)
        meshes = geometric_coarsening_sequence(mesh)
        self._assemble_levels([FESpace(m, degree) for m in meshes],
                              "h" * (len(meshes) - 1))

    def _build_level(self, space: FESpace, coarse: bool) -> tuple:
        kernel = self.variant == "auto" and space.dim == 3
        if kernel:
            op = make_cuda_elasticity(space, self.dtype, self.mu, self.lam,
                                      self.device)
        else:
            # "auto" falls back to kron where B.5 does not apply (2D)
            variant = "kron" if self.variant == "auto" else self.variant
            op = make_elasticity(space, self.dtype, self.mu, self.lam,
                                 variant, self.device)
        if coarse:
            smoother = make_chebyshev(op, smoothing_range=1e-3, degree=None,
                                      eig_cg_n_iterations=op.n_dofs)
            return op, smoother
        # float32: the JAX package's switches of the recurrence's grade and
        # of its fusion (its _maybe_mxu_recurrence); float64 runs fused
        # and exact
        grade = kernel and self.dtype == torch.float32
        mxu = None
        if grade and os.environ.get("PMG_ELASTICITY_MXU", "1") == "1":
            mxu = make_cuda_elasticity(space, self.dtype, self.mu, self.lam,
                                       self.device, core="mxu")
        fused = kernel and (not grade or os.environ.get(
            "PMG_ELASTICITY_FUSED", "1") == "1")
        smoother = make_chebyshev(
            op, smoothing_range=15.0, degree=5, eig_cg_n_iterations=10,
            fused=fused, fused_smoother_op=mxu if fused else None)
        if mxu is not None and not fused:
            smoother = dataclasses.replace(smoother, op=mxu)
        return op, smoother

    def rhs(self, f=None) -> torch.Tensor:
        """The scalar load vector on every component."""
        fine = self.spaces[-1]
        b = assemble_rhs(fine, f=f)
        return torch.as_tensor(
            np.broadcast_to(b[None], (fine.dim,) + fine.grid_shape).copy(),
            dtype=self.dtype, device=self.device)
