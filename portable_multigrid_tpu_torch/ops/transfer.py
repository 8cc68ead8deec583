"""Geometric (h) and polynomial (p) grid transfers on structured grids
(plain torch).

Counterpart of ``portable_multigrid_tpu/ops/transfer.py``
(``Transfer``, ``TrimmedTransfer``, ``make_h_transfer``,
``make_p_transfer``, ``_weights_1d``):
the reference's ``Portable::GeometricTransfer`` (reference:
include/multigrid/portable_geometric_transfer.h:687-1487) reduces on a
tensor-product grid to one separable per-axis schedule:

  prolongate:  per axis: split coarse windows (stride p_c) -> contract with
               M1[w_f, q_c] -> overlap-add at fine stride -> fine weights.
  restrict:    the exact transpose: weights first, windows at fine stride,
               M1^T, overlap-add at coarse stride, coarse mask last.

Weights are 1/valence with constrained fine DoFs zeroed (reference:
include/multigrid/portable_geometric_transfer.h:1337-1355).  A field with a
leading component axis (elasticity) carries it through every step, as the
JAX ``Transfer`` does with ``jax.vmap``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..fem.basis import h_prolongation_matrix_1d, p_prolongation_matrix_1d
from ..fem.space import FESpace
from ..utils.tensors import to_tensor
from .laplace import bcast
from .structured import contract, overlap_add, split_windows


@dataclasses.dataclass
class Transfer:
    """Two-level transfer on structured grids."""

    dim: int
    n_coarse: tuple  # coarse cells per axis
    stride_c: int  # p_coarse
    stride_f: int  # 2p (h-transfer)
    M1: torch.Tensor  # [stride_f+1, stride_c+1] 1D prolongation
    wmask_f: tuple  # per-axis [N_f] fine weights * fine mask factors
    mask_c1: tuple  # per-axis [N_c] coarse mask factors

    def prolongate(self, c: torch.Tensor) -> torch.Tensor:
        """P c: coarse grid -> fine grid (both masked, fine side weighted)."""
        lead = c.ndim - self.dim  # leading (component) axes ride along
        t = c
        for ax in range(self.dim):
            t = t * bcast(self.mask_c1[ax], ax, self.dim)
        for ax in range(self.dim):
            a = lead + ax
            t = split_windows(t, a, self.n_coarse[ax], self.stride_c)
            t = contract(t, self.M1, a + 1)
            t = overlap_add(t, a, self.n_coarse[ax], self.stride_f)
            t = t * bcast(self.wmask_f[ax], ax, self.dim)
        return t

    def prolongate_and_add(self, dst: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """dst + P c (reference: portable_geometric_transfer.h:760-823)."""
        return dst + self.prolongate(c)

    def restrict(self, f: torch.Tensor) -> torch.Tensor:
        """P^T f: fine grid -> coarse grid (exact transpose of prolongate)."""
        lead = f.ndim - self.dim
        t = f
        for ax in range(self.dim):
            t = t * bcast(self.wmask_f[ax], ax, self.dim)  # weights first
        for ax in range(self.dim):
            a = lead + ax
            t = split_windows(t, a, self.n_coarse[ax], self.stride_f)
            t = contract(t, self.M1.T, a + 1)
            t = overlap_add(t, a, self.n_coarse[ax], self.stride_c)
            t = t * bcast(self.mask_c1[ax], ax, self.dim)
        return t


def pad_last_planes(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Trimmed state -> full grid: append the (zero) global last plane on
    each of the trailing ``dim`` (spatial) axes; a leading component axis
    is left alone."""
    return torch.nn.functional.pad(t, (0, 1) * dim)


def trim_last_planes(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Full grid -> trimmed state: drop the global last plane on each of the
    trailing ``dim`` (spatial) axes (a view; the kernels take it after
    ``.contiguous()``)."""
    return t[(...,) + (slice(0, -1),) * dim]


@dataclasses.dataclass
class TrimmedTransfer:
    """Adapter between trimmed-state levels (global last plane per axis
    dropped, constrained entries zero) and a full-grid :class:`Transfer`.

    ``fine_trimmed`` / ``coarse_trimmed`` mark each side's representation;
    padding and trimming happen only where they differ from the base
    transfer's full grid (the padded planes are Dirichlet-constrained and
    identically zero in both representations)."""

    fine_trimmed: bool
    coarse_trimmed: bool
    base: Transfer

    def restrict(self, f: torch.Tensor) -> torch.Tensor:
        dim = self.base.dim
        if self.fine_trimmed:
            f = pad_last_planes(f, dim)
        c = self.base.restrict(f)
        # the coarse level's kernels take contiguous trimmed state
        return (trim_last_planes(c, dim).contiguous() if self.coarse_trimmed
                else c)

    def prolongate(self, c: torch.Tensor) -> torch.Tensor:
        dim = self.base.dim
        if self.coarse_trimmed:
            c = pad_last_planes(c, dim)
        t = self.base.prolongate(c)
        return trim_last_planes(t, dim) if self.fine_trimmed else t

    def prolongate_and_add(self, dst: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        return dst + self.prolongate(c)


def _weights_1d(n_coarse: int, stride_f: int) -> np.ndarray:
    """Per-axis 1/valence weights on the fine grid: 0.5 at interior
    coarse-cell boundary points, 1 elsewhere."""
    N_f = n_coarse * stride_f + 1
    w = np.ones(N_f)
    if n_coarse > 1:
        w[stride_f:-1:stride_f] = 0.5
    return w


def _transfer(coarse: FESpace, fine: FESpace, stride_f: int, M1: np.ndarray,
              dtype, device) -> Transfer:
    """The separable transfer with 1D matrix M1 [stride_f+1, p_c+1], fine
    weights 1/valence times the fine mask, coarse mask last."""
    n_c = coarse.mesh.cells_per_axis
    dim = coarse.dim
    w = _weights_1d(n_c, stride_f) * fine.free_mask_1d()
    t = functools.partial(to_tensor, dtype=dtype, device=device)
    return Transfer(
        dim=dim,
        n_coarse=(n_c,) * dim,
        stride_c=coarse.degree,
        stride_f=stride_f,
        M1=t(M1),
        wmask_f=(t(w),) * dim,
        mask_c1=(t(coarse.free_mask_1d()),) * dim,
    )


def make_h_transfer(coarse: FESpace, fine: FESpace, dtype=torch.float64,
                    device="cpu") -> Transfer:
    """Geometric transfer between two uniformly refined levels, equal degree."""
    if coarse.degree != fine.degree:
        raise ValueError("h-transfer requires equal degrees")
    if fine.mesh.cells_per_axis != 2 * coarse.mesh.cells_per_axis:
        raise ValueError("fine mesh must be one refinement of the coarse mesh")
    p = coarse.degree
    return _transfer(coarse, fine, 2 * p, h_prolongation_matrix_1d(p), dtype,
                     device)


def make_p_transfer(coarse: FESpace, fine: FESpace, dtype=torch.float64,
                    device="cpu") -> Transfer:
    """Polynomial transfer on one mesh between degrees p_coarse < p_fine.

    Plain torch on every device: the JAX package has no kernel for it and
    leaves it to XLA."""
    if coarse.mesh.cells_per_axis != fine.mesh.cells_per_axis:
        raise ValueError("p-transfer requires the same mesh")
    return _transfer(coarse, fine, fine.degree,
                     p_prolongation_matrix_1d(coarse.degree, fine.degree),
                     dtype, device)
