"""Vector-valued linear elasticity operator (plain torch, Kronecker form).

Counterpart of ``portable_multigrid_tpu/ops/elasticity.py`` for the
``"kron"`` variant (``ElasticityOperator.apply_kron``,
``element_stiffness_elasticity``, ``assembled_1d_gradient``,
``make_elasticity``, and ``_elasticity_diagonal`` and
``dense_elasticity_operator`` as test oracles).  Weak form

    a(u, v) = ∫ 2 mu eps(u) : eps(v) + lambda (div u)(div v) dx

on the structured hyper-cube mesh with homogeneous Dirichlet on the whole
boundary.  On the tensor-product mesh it factorizes exactly into Kronecker
chains of the assembled 1D stiffness K, mass M and gradient matrix
G[i, j] = ∫ l_i' l_j dx; per output component c

    out_c = sum_a alpha_{a,c} (K@a, M elsewhere) u_c
          + sum_{a != c} mu (G@a, G^T@c, M elsewhere) u_a
                       + lam (G@c, G^T@a, M elsewhere) u_a

with alpha_{c,c} = 2 mu + lam and mu otherwise.  Vectors are
[dim, N, ..., N] (component-major).  The inverse diagonal is built in the
separable closed form of ``pallas_elasticity.py:117-140`` (only the
diagonal blocks reach the matrix diagonal), never by the element loop.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fem.assemble import gradient_matrices
from ..fem.basis import gauss_points
from ..fem.space import FESpace
from .laplace import (
    assembled_1d_matrices,
    bcast,
    diagonal_1d_factors,
    reject_variant,
    separable_mask,
)
from .structured import contract

# variants of the JAX package's elasticity operator that the port does not
# carry yet, with the ROADMAP item that brings each one
_LATER_VARIANTS = {
    "sumfac": "ROADMAP A.10 (sum-factorized elasticity apply)",
    "dense": "ROADMAP A.10 (dense element-matrix elasticity apply)",
}


def alpha(a: int, c: int, mu: float, lam: float) -> float:
    """Weight of the stiffness chain with K on axis ``a`` in output ``c``."""
    return 2.0 * mu + lam if a == c else mu


def elasticity_kron(u: torch.Tensor, K, M, G, GT, mu: float,
                    lam: float) -> torch.Tensor:
    """The Kronecker chains on a [dim, N, ..., N] field, the same 1D matrices
    on every axis (``ElasticityOperator.apply_kron`` of the JAX package)."""
    dim = u.shape[0]

    def kron(w, mats):
        for ax in reversed(range(dim)):
            w = contract(w, mats[ax], ax)
        return w

    def pattern(e, f):
        """Per-axis matrices for D(∂e, ∂f), e != f."""
        return tuple(G if a == e else GT if a == f else M for a in range(dim))

    outs = []
    for c in range(dim):
        out = None
        for a in range(dim):
            mats = tuple(K if ax == a else M for ax in range(dim))
            t = alpha(a, c, mu, lam) * kron(u[c], mats)
            out = t if out is None else out + t
        for a in range(dim):
            if a == c:
                continue
            out = out + mu * kron(u[a], pattern(a, c))
            out = out + lam * kron(u[a], pattern(c, a))
        outs.append(out)
    return torch.stack(outs)


def separable_elasticity_diagonal(dK1, dM1, mu: float, lam: float,
                                  dim: int) -> torch.Tensor:
    """[dim, grid]: diag_c = sum_k alpha_{k,c} (x)_d (dK1 if d == k else dM1)
    (raw values on constrained entries)."""
    terms = []
    for k in range(dim):
        term = None
        for d in range(dim):
            f = bcast(dK1 if d == k else dM1, d, dim)
            term = f if term is None else term * f
        terms.append(term)
    return torch.stack([sum(alpha(k, c, mu, lam) * terms[k]
                            for k in range(dim)) for c in range(dim)])


def elasticity_inv_diag(op) -> torch.Tensor:
    """[dim, grid] inverse diagonal of an elasticity operator (kron or
    B.5), constrained entries 1."""
    m = op.mask
    diag = separable_elasticity_diagonal(op.dK1, op.dM1, op.mu, op.lam,
                                         op.dim)
    return 1.0 / (diag * m + (1.0 - m))


@dataclasses.dataclass
class ElasticityOperator:
    """Kronecker-form elasticity operator holding its 1D factors as tensors
    (the same on every axis)."""

    dim: int
    degree: int
    n: int  # cells per axis
    mu: float
    lam: float
    mask1: torch.Tensor  # [N] free-DoF mask factor
    dK1: torch.Tensor  # [N] assembled stiffness diagonal (h-folded)
    dM1: torch.Tensor  # [N] assembled mass diagonal
    Kg: torch.Tensor  # [N, N] assembled 1D stiffness
    Mg: torch.Tensor  # [N, N] assembled 1D mass
    Gg: torch.Tensor  # [N, N] assembled 1D gradient (test-derivative rows)

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return (self.n * self.degree + 1,) * self.dim

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.dim,) + self.grid_shape

    @property
    def n_dofs(self) -> int:
        return int(np.prod(self.shape))

    @property
    def dtype(self):
        return self.mask1.dtype

    @property
    def device(self):
        return self.mask1.device

    @property
    def mask(self) -> torch.Tensor:
        """Scalar grid mask, shared by every component."""
        return separable_mask((self.mask1,) * self.dim)

    @property
    def inv_diag(self) -> torch.Tensor:
        return elasticity_inv_diag(self)

    def apply_kron(self, um: torch.Tensor) -> torch.Tensor:
        return elasticity_kron(um, self.Kg, self.Mg, self.Gg, self.Gg.T,
                               self.mu, self.lam)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """Full vmult with constrained-DoF semantics, component by component:
        A_eff = M A M + (I - M)."""
        u = u.reshape(self.shape)
        m = self.mask
        au = self.apply_kron(u * m)
        return m * au + (1.0 - m) * u


def element_stiffness_elasticity(degree: int, dim: int, h: float, mu: float,
                                 lam: float) -> np.ndarray:
    """Dense elasticity element matrix [(dim*ndof)]^2, component-major
    ((c, i) lexicographic), for the test oracles."""
    G = gradient_matrices(degree, dim)  # G_d[Q, ndof] reference gradients
    _, qw = gauss_points(degree + 1)
    wq = np.array([1.0])
    for _ in range(dim):
        wq = np.kron(wq, qw)
    W = wq * h ** (dim - 2)
    ndof = (degree + 1) ** dim
    A = np.zeros((dim, ndof, dim, ndof))
    gradgrad = sum((Gd * W[:, None]).T @ Gd for Gd in G)
    for c in range(dim):
        A[c, :, c, :] += mu * gradgrad
        for cp in range(dim):
            # mu d_cp phi_i d_c phi_j + lam d_c phi_i d_cp phi_j
            A[c, :, cp, :] += mu * (G[cp] * W[:, None]).T @ G[c]
            A[c, :, cp, :] += lam * (G[c] * W[:, None]).T @ G[cp]
    return A.reshape(dim * ndof, dim * ndof)


def elasticity_diagonal_by_elements(space: FESpace, mu: float,
                                    lam: float) -> np.ndarray:
    """Assembled diagonal [dim, grid] by the element loop of the JAX
    package's ``_elasticity_diagonal`` (a test oracle: it calls
    ``np.add.at`` once per cell and component)."""
    A = element_stiffness_elasticity(space.degree, space.dim, space.mesh.h,
                                     mu, lam)
    d_loc = np.diag(A).reshape(space.dim, -1)
    l2g = space.local_to_global()
    diag = np.zeros((space.dim, space.n_dofs))
    for e in range(l2g.shape[0]):
        for c in range(space.dim):
            np.add.at(diag[c], l2g[e], d_loc[c])
    diag = diag.reshape((space.dim,) + space.grid_shape)
    m = space.free_mask()[None]
    return diag * m + (1.0 - m)


def assembled_1d_gradient(space: FESpace) -> np.ndarray:
    """Assembled 1D gradient matrix on the axis DoF grid (NumPy):
    G1[i,j] = ∫ l_i' l_j dx over the 1D mesh (test-derivative rows; h-free —
    the 1/h of the derivative cancels the h of dx)."""
    b = space.basis
    W = np.diag(b.q_weights)
    Gc = b.D.T @ W @ b.B
    p = space.degree
    G1 = np.zeros((space.points_per_axis,) * 2)
    for c in range(space.mesh.cells_per_axis):
        sl = slice(c * p, c * p + p + 1)
        G1[sl, sl] += Gc
    return G1


def dense_elasticity_operator(space: FESpace, mu: float = 1.0,
                              lam: float = 1.0) -> np.ndarray:
    """Dense golden elasticity operator with constrained-DoF semantics,
    component-major global ordering ((c, dof) lexicographic)."""
    A_loc = element_stiffness_elasticity(space.degree, space.dim,
                                         space.mesh.h, mu, lam)
    dim = space.dim
    nd = space.n_dofs
    l2g = space.local_to_global()
    N = dim * nd
    A = np.zeros((N, N))
    for e in range(l2g.shape[0]):
        idx = np.concatenate([c * nd + l2g[e] for c in range(dim)])
        A[np.ix_(idx, idx)] += A_loc
    m = np.tile(space.free_mask().reshape(-1), dim)
    A = A * m[:, None] * m[None, :]
    A[np.arange(N), np.arange(N)] += 1.0 - m
    return A


def elasticity_from_factors(*, dim: int, degree: int, n: int, mu: float,
                            lam: float, m1, gK, gM, K1, M1, G1,
                            dtype=torch.float64,
                            device="cpu") -> ElasticityOperator:
    """Pack the kron operator from its 1D factors (NumPy, float64)."""
    def t(a):
        return torch.as_tensor(np.array(a, np.float64), dtype=dtype,
                               device=device)

    return ElasticityOperator(dim=dim, degree=degree, n=n, mu=float(mu),
                              lam=float(lam), mask1=t(m1), dK1=t(gK),
                              dM1=t(gM), Kg=t(K1), Mg=t(M1), Gg=t(G1))


def make_elasticity(space: FESpace, dtype=torch.float64, mu: float = 1.0,
                    lam: float = 1.0, variant: str = "kron",
                    device="cpu") -> ElasticityOperator:
    """Build the kron elasticity operator for a space on ``device``."""
    if variant != "kron":
        reject_variant(variant, _LATER_VARIANTS)
    gK, gM = diagonal_1d_factors(space)
    K1, M1 = assembled_1d_matrices(space)
    return elasticity_from_factors(
        dim=space.dim, degree=space.degree, n=space.mesh.cells_per_axis,
        mu=mu, lam=lam, m1=space.free_mask_1d(), gK=gK, gM=gM, K1=K1, M1=M1,
        G1=assembled_1d_gradient(space), dtype=dtype, device=device)
