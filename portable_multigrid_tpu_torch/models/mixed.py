"""Mixed multigrid configurations (torch port).

Counterpart of ``portable_multigrid_tpu/models/mixed.py``:

  * :class:`MixedMultigridPoisson` — BASELINE config 3: a polynomial ladder
    on the finest mesh (e.g. p = 4 -> 2 -> 1) handing off to geometric
    levels at the lowest degree.  The V-cycle is transfer-agnostic, so this
    is a different level list: h-pairs below, p-pairs above.
  * :class:`MixedPrecisionPoisson` — BASELINE config 5 on one device: the
    V-cycle runs in ``mg_dtype`` (float32) while the outer CG runs in
    float64 on the fine operator in float64.

Variants as in ``models/poisson.py``: ``"auto"`` runs the kernel operator
on every level (B.1 with B.2 pairs in 3D, B.4 in 2D; on float32 levels the
recurrence at the JAX package's bf16 grade, ``models/poisson.py``
``_build_level``), B.3 on the 3D h-pairs and the plain p-transfer, adapted
to trimmed state, on the p-pairs;
``"kron"``, ``"sumfac"`` (the JAX package's default for both models) and
``"dense"`` are the plain paths.  Under ``"auto"`` the float64 outer
operator of :class:`MixedPrecisionPoisson` is the kernel operator's
full-grid apply; the JAX package has no such variant and runs config 5 on
its XLA operators.
"""

from __future__ import annotations

import torch

from ..fem.mesh import HyperCubeMesh, geometric_coarsening_sequence
from ..fem.space import FESpace
from ..ops.cuda_laplace import make_cuda_laplace
from ..ops.cuda_laplace2d import make_cuda_laplace2d
from ..ops.laplace import make_laplace
from .poisson import _MultigridBase


class MixedMultigridPoisson(_MultigridBase):
    """p-ladder on the finest mesh over geometric coarsening below it
    (config 3); ``p_ladder`` runs coarse to fine."""

    def __init__(self, dim: int, refinements: int,
                 p_ladder: tuple[int, ...] = (1, 2, 4), dtype=torch.float64,
                 variant: str = "auto", device="cuda"):
        super().__init__(dtype, variant, device)
        mesh = HyperCubeMesh(dim, refinements)
        meshes = geometric_coarsening_sequence(mesh)
        # geometric levels at the lowest degree, then the rest of the
        # ladder on the finest mesh
        spaces = [FESpace(m, p_ladder[0]) for m in meshes]
        spaces += [FESpace(mesh, p) for p in p_ladder[1:]]
        self._assemble_levels(spaces, "h" * (len(meshes) - 1)
                              + "p" * (len(p_ladder) - 1))


class MixedPrecisionPoisson(_MultigridBase):
    """float64 CG preconditioned by a V-cycle in ``mg_dtype`` over the
    geometric coarsening sequence (config 5).  The casts of the residual to
    ``mg_dtype`` and of the correction back to float64 run inside the
    V-cycle (and so inside its CUDA graph)."""

    io_dtype = torch.float64

    def __init__(self, dim: int, degree: int, refinements: int,
                 mg_dtype=torch.float32, variant: str = "auto",
                 device="cuda"):
        super().__init__(mg_dtype, variant, device)
        mesh = HyperCubeMesh(dim, refinements)
        meshes = geometric_coarsening_sequence(mesh)
        self._assemble_levels([FESpace(m, degree) for m in meshes],
                              "h" * (len(meshes) - 1))
        fine = self.spaces[-1]
        if variant == "auto":
            make_op = {2: make_cuda_laplace2d, 3: make_cuda_laplace}[dim]
            self.fine_op64 = make_op(fine, torch.float64, self.device)
        else:
            self.fine_op64 = make_laplace(fine, torch.float64, variant,
                                          self.device)

    @property
    def fine_operator(self):
        return self.fine_op64
