"""Matrix-free Laplace operator on a structured Q_p space (plain torch).

Counterpart of ``portable_multigrid_tpu/ops/laplace.py`` for the ``"kron"``
variant: on a tensor-product mesh with Cartesian geometry the assembled
operator factorizes as

    A = Kx (x) My (x) Mz + Mx (x) Ky (x) Mz + Mx (x) My (x) Kz

with banded assembled 1D stiffness/mass matrices, so the apply is a handful
of 1D contractions on the contiguous DoF grid.  Constrained-DoF semantics
are the reference's: A_eff = M A M + (I - M) with M the separable Dirichlet
grid mask (reference: include/operators/portable_laplace_operator.h:557-719).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fem.basis import make_basis
from ..fem.space import FESpace
from .structured import contract

# variants of the JAX package that the port does not carry yet, with the
# ROADMAP item that brings each one
_LATER_VARIANTS = {
    "sumfac": "ROADMAP A.3 (sum-factorized apply_local)",
    "dense": "ROADMAP A.3 (dense element-matrix variant)",
    "bkron": "ROADMAP queue B 'not to port' (TPU MXU block packing)",
    "qdense": "ROADMAP A.11 (variable coefficients)",
    "qbanded": "ROADMAP A.11 (variable coefficients)",
}


def reject_variant(variant: str, later: dict = _LATER_VARIANTS) -> None:
    """Raise for a variant the port does not carry; ``later`` maps the known
    ones to the ROADMAP item that brings each."""
    if variant in later:
        raise ValueError(
            f"operator variant {variant!r} is not ported yet: "
            f"{later[variant]}")
    raise ValueError(f"unknown operator variant: {variant!r}")


def bcast(v: torch.Tensor, ax: int, dim: int) -> torch.Tensor:
    """Reshape a per-axis 1D factor for broadcasting onto a dim-D grid."""
    shp = [1] * dim
    shp[ax] = v.shape[0]
    return v.reshape(shp)


def separable_mask(mask1) -> torch.Tensor:
    """Grid mask as the outer product of per-axis factors."""
    dim = len(mask1)
    m = bcast(mask1[0], 0, dim)
    for d in range(1, dim):
        m = m * bcast(mask1[d], d, dim)
    return m


def separable_diagonal(dK1, dM1) -> torch.Tensor:
    """diag = sum_k (x)_d (dK1[d] if d == k else dM1[d]) — the Kronecker-sum
    structure of the Cartesian operator's diagonal."""
    dim = len(dK1)
    diag = None
    for k in range(dim):
        term = None
        for d in range(dim):
            f = bcast(dK1[d] if d == k else dM1[d], d, dim)
            term = f if term is None else term * f
        diag = term if diag is None else diag + term
    return diag


def separable_inv_diag(mask1, dK1, dM1) -> torch.Tensor:
    """Inverse matrix diagonal with constrained DoFs = 1."""
    m = separable_mask(mask1)
    return 1.0 / (separable_diagonal(dK1, dM1) * m + (1.0 - m))


@dataclasses.dataclass
class LaplaceOperator:
    """Kronecker-sum Laplace operator holding its 1D factors as tensors."""

    dim: int
    degree: int
    n: tuple  # cells per axis
    mask1: tuple  # per-axis [N_d] free-DoF mask factors
    dK1: tuple  # per-axis assembled 1D stiffness diagonals (h-folded)
    dM1: tuple  # per-axis assembled 1D mass diagonals
    Kg: tuple  # per-axis assembled 1D stiffness [N_d, N_d]
    Mg: tuple  # per-axis assembled 1D mass [N_d, N_d]

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return tuple(nd * self.degree + 1 for nd in self.n)

    @property
    def shape(self) -> tuple[int, ...]:
        """Shape of a field (one component)."""
        return self.grid_shape

    @property
    def n_dofs(self) -> int:
        return int(np.prod(self.grid_shape))

    @property
    def dtype(self):
        return self.mask1[0].dtype

    @property
    def device(self):
        return self.mask1[0].device

    @property
    def mask(self) -> torch.Tensor:
        return separable_mask(self.mask1)

    @property
    def inv_diag(self) -> torch.Tensor:
        return separable_inv_diag(self.mask1, self.dK1, self.dM1)

    def apply_kron(self, um: torch.Tensor) -> torch.Tensor:
        """Unmasked A um via the assembled per-axis 1D matrices."""
        dim = self.dim
        if dim == 1:
            return contract(um, self.Kg[0], 0)
        if dim == 2:
            b = contract(um, self.Mg[1], 1)
            a = contract(um, self.Kg[1], 1)
            return contract(b, self.Kg[0], 0) + contract(a, self.Mg[0], 0)
        # dim == 3: 8 contractions with common-subexpression sharing
        b = contract(um, self.Mg[2], 2)  # M_z u
        a = contract(um, self.Kg[2], 2)  # K_z u
        mb = contract(b, self.Mg[1], 1)
        kb = contract(b, self.Kg[1], 1)
        ma = contract(a, self.Mg[1], 1)
        return contract(mb, self.Kg[0], 0) + contract(kb + ma, self.Mg[0], 0)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """Full vmult with constrained-DoF semantics: A_eff = M A M + (I - M)."""
        u = u.reshape(self.grid_shape)
        m = self.mask
        au = self.apply_kron(u * m)
        return m * au + (1.0 - m) * u


def diagonal_1d_factors(space: FESpace) -> tuple[np.ndarray, np.ndarray]:
    """Per-axis 1D diagonal factors (gK, gM) with h^(dim-2) folded into gK.

    The grid diagonal is sum_k (x)_d (gK if d==k else gM) — each Kronecker
    term carries exactly one stiffness factor, so the global h power folds
    into gK once."""
    b = make_basis(space.degree)
    W = np.diag(b.q_weights)
    dM = np.diag(b.B.T @ W @ b.B)
    dK = np.diag(b.D.T @ W @ b.D)
    n, p = space.mesh.cells_per_axis, space.degree
    N = n * p + 1
    gM = np.zeros(N)
    gK = np.zeros(N)
    for c in range(n):
        sl = slice(c * p, c * p + p + 1)
        gM[sl] += dM
        gK[sl] += dK
    return gK * space.mesh.h ** (space.dim - 2), gM


def assembled_1d_matrices(space: FESpace) -> tuple[np.ndarray, np.ndarray]:
    """Assembled 1D stiffness/mass matrices on the axis DoF grid (NumPy).

    K1[i,j] = ∫ l_i' l_j' dx,  M1[i,j] = ∫ l_i l_j dx over the 1D mesh, with
    the per-cell (p+1)-point Gauss rule (exact for both integrands)."""
    b = space.basis
    W = np.diag(b.q_weights)
    Kc = (b.D.T @ W @ b.D) / space.mesh.h
    Mc = (b.B.T @ W @ b.B) * space.mesh.h
    n = space.mesh.cells_per_axis
    p = space.degree
    N = space.points_per_axis
    K1 = np.zeros((N, N))
    M1 = np.zeros((N, N))
    for c in range(n):
        sl = slice(c * p, c * p + p + 1)
        K1[sl, sl] += Kc
        M1[sl, sl] += Mc
    return K1, M1


def make_laplace(space: FESpace, dtype=torch.float64, variant: str = "kron",
                 device="cpu") -> LaplaceOperator:
    """Build the kron operator for a space on ``device``."""
    if variant != "kron":
        reject_variant(variant)
    dim = space.dim
    gK, gM = diagonal_1d_factors(space)
    K1, M1 = assembled_1d_matrices(space)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return LaplaceOperator(
        dim=dim,
        degree=space.degree,
        n=(space.mesh.cells_per_axis,) * dim,
        mask1=(t(space.free_mask_1d()),) * dim,
        dK1=(t(gK),) * dim,
        dM1=(t(gM),) * dim,
        Kg=(t(K1),) * dim,
        Mg=(t(M1),) * dim,
    )
