"""Vector-valued linear elasticity operator (plain torch).

Counterpart of ``portable_multigrid_tpu/ops/elasticity.py``
(``ElasticityOperator`` with its ``"kron"``, ``"sumfac"`` and ``"dense"``
variants, ``element_stiffness_elasticity``, ``assembled_1d_gradient``,
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

with alpha_{c,c} = 2 mu + lam and mu otherwise (``"kron"``).  ``"sumfac"``
evaluates the full gradient tensor at the quadrature points of every
element and integrates the stress tau = mu (G + G^T) + lam tr(G) I back
(the reference's q-point stage, portable_laplace_operator.h:300-325);
``"dense"`` applies the constant vector-valued element matrix as one
product over all elements.  Vectors are [dim, N, ..., N]
(component-major).  The inverse diagonal is built in the
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
from ..utils.tensors import to_tensor
from .laplace import (
    assembled_1d_matrices,
    bcast,
    diagonal_1d_factors,
    element_perm,
    inverse_perm,
    quadrature_metric,
    reject_variant,
    separable_mask,
)
from .structured import contract, matmul, overlap_add_all, split_all


def alpha(a: int, c: int, mu: float, lam: float) -> float:
    """Weight of the stiffness chain with K on axis ``a`` in output ``c``."""
    return 2.0 * mu + lam if a == c else mu


def _per_axis(v, dim: int) -> tuple:
    """Per-axis factors: a tuple as it is, one tensor for every axis."""
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * dim


def elasticity_chains(mu: float, lam: float, dim: int = 3) -> list:
    """The Kronecker chains of the weak form as (output c, input a, the
    per-axis matrix names, weight), a name K, M, G or H = G^T, in the
    order :func:`elasticity_kron` sums them: per output the stiffness
    chains (K on axis k, alpha_{k,c}), then per other input a the two
    couplings, mu (G@a, H@c) and lam (G@c, H@a)."""
    out = []
    for c in range(dim):
        for k in range(dim):
            out.append((c, c, "".join("K" if ax == k else "M"
                                      for ax in range(dim)),
                        alpha(k, c, mu, lam)))
        for a in range(dim):
            if a == c:
                continue
            for e, f, w in ((a, c, mu), (c, a, lam)):
                out.append((c, a, "".join("G" if ax == e else "H" if ax == f
                                          else "M" for ax in range(dim)), w))
    return out


def elasticity_kron(u: torch.Tensor, K, M, G, GT, mu: float,
                    lam: float) -> torch.Tensor:
    """The Kronecker chains on a [dim, ...] field
    (``ElasticityOperator.apply_kron`` of the JAX package): ``K``, ``M``,
    ``G`` and ``GT`` one 1D matrix for every axis, or a tuple of one per
    axis (a slab's x matrices its own, [L, L + 1] on its x-full input)."""
    dim = u.shape[0]
    mats = dict(zip("KMGH", (_per_axis(W, dim) for W in (K, M, G, GT))))
    outs = [None] * dim
    for c, a, names, w in elasticity_chains(mu, lam, dim):
        t = u[a]
        for ax in reversed(range(dim)):
            t = contract(t, mats[names[ax]][ax], ax)
        t = w * t
        outs[c] = t if outs[c] is None else outs[c] + t
    return torch.stack(outs)


def separable_elasticity_diagonal(dK1, dM1, mu: float, lam: float,
                                  dim: int) -> torch.Tensor:
    """[dim, grid]: diag_c = sum_k alpha_{k,c} (x)_d (dK1 if d == k else dM1)
    (raw values on constrained entries); ``dK1``, ``dM1`` one factor for
    every axis or a tuple of one per axis."""
    dK1, dM1 = _per_axis(dK1, dim), _per_axis(dM1, dim)
    terms = []
    for k in range(dim):
        term = None
        for d in range(dim):
            f = bcast(dK1[d] if d == k else dM1[d], d, dim)
            term = f if term is None else term * f
        terms.append(term)
    return torch.stack([sum(alpha(k, c, mu, lam) * terms[k]
                            for k in range(dim)) for c in range(dim)])


def elasticity_inv_diag(op, dK1=None, dM1=None) -> torch.Tensor:
    """[dim, grid] inverse diagonal of an elasticity operator (kron or
    B.5), constrained entries 1; ``dK1``, ``dM1`` the per-axis diagonal
    factors where they are not the operator's own (a B.5 slab's)."""
    m = op.mask
    diag = separable_elasticity_diagonal(
        op.dK1 if dK1 is None else dK1, op.dM1 if dM1 is None else dM1,
        op.mu, op.lam, op.dim)
    return 1.0 / (diag * m + (1.0 - m))


@dataclasses.dataclass
class ElasticityOperator:
    """Elasticity operator holding its state as tensors, per axis (a
    slab of the sharded solve has an x extent and x factors of its own,
    ``parallel/elasticity.py``); the fields a variant does not use stay
    None."""

    dim: int
    degree: int
    n: tuple  # cells per axis
    mu: float
    lam: float
    mask1: tuple  # per-axis [N_d] free-DoF mask factors
    dK1: tuple  # per-axis assembled stiffness diagonals (h-folded)
    dM1: tuple  # per-axis assembled mass diagonals
    variant: str = "kron"
    Kg: tuple = None  # per-axis [N_d, N_d] assembled 1D stiffness
    Mg: tuple = None  # per-axis [N_d, N_d] assembled 1D mass
    # per-axis [N_d, N_d] assembled 1D gradient (test-derivative rows)
    Gg: tuple = None
    B: torch.Tensor = None  # [nq, p+1] shape values at the quadrature points
    Dco: torch.Tensor = None  # [nq, nq] collocation derivative
    qmetric: torch.Tensor = None  # [nq]^dim: w_q (x) ... (x) w_q h^(dim-2)
    elem_matrix: torch.Tensor = None  # [dim (p+1)^dim]^2, component-major

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return tuple(nd * self.degree + 1 for nd in self.n)

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.dim,) + self.grid_shape

    @property
    def n_dofs(self) -> int:
        return int(np.prod(self.shape))

    @property
    def dtype(self):
        return self.mask1[0].dtype

    @property
    def device(self):
        return self.mask1[0].device

    @property
    def mask(self) -> torch.Tensor:
        """Scalar grid mask, shared by every component."""
        return separable_mask(self.mask1)

    @property
    def inv_diag(self) -> torch.Tensor:
        return elasticity_inv_diag(self)

    def apply_kron(self, um: torch.Tensor) -> torch.Tensor:
        return elasticity_kron(um, self.Kg, self.Mg, self.Gg,
                               tuple(G.T for G in self.Gg), self.mu, self.lam)

    def apply_sumfac(self, um: torch.Tensor) -> torch.Tensor:
        """Gather, the gradient tensor G[c][d] at the quadrature points, the
        stress tau[c][d] = mu (G[c,d] + G[d,c]) + lam delta_cd tr(G) scaled
        by the q-point weights, the transposed gradients and basis change
        back, and the scatter, per component."""
        dim, p, n = self.dim, self.degree, self.n
        nq = self.B.shape[0]
        qaxes = [2 * d + 1 for d in range(dim)]
        w = self.qmetric.reshape(tuple(1 if a % 2 == 0 else nq
                                       for a in range(2 * dim)))
        vals = []
        for c in range(dim):
            v = split_all(um[c], dim, n, p)
            for ax in qaxes:
                v = contract(v, self.B, ax)
            vals.append(v)
        G = [[contract(vals[c], self.Dco, qaxes[d]) for d in range(dim)]
             for c in range(dim)]
        trG = G[0][0]
        for d in range(1, dim):
            trG = trG + G[d][d]
        outs = []
        for c in range(dim):
            r = None
            for d in range(dim):
                tau = self.mu * (G[c][d] + G[d][c])
                if c == d:
                    tau = tau + self.lam * trG
                g = contract(tau * w, self.Dco.T, qaxes[d])
                r = g if r is None else r + g
            for ax in qaxes:
                r = contract(r, self.B.T, ax)
            outs.append(overlap_add_all(r, dim, n, p))
        return torch.stack(outs)

    def apply_dense(self, um: torch.Tensor) -> torch.Tensor:
        """The element loop, all component couplings included, as one
        [E, dim (p+1)^dim] @ [dim (p+1)^dim]^2 product with the constant
        element matrix."""
        dim, p, n = self.dim, self.degree, self.n
        q = p + 1
        perm = element_perm(dim)
        flat = torch.cat([split_all(um[c], dim, n, p).permute(perm)
                          .reshape(-1, q ** dim) for c in range(dim)], dim=1)
        r = matmul(flat, self.elem_matrix)
        return torch.stack([
            overlap_add_all(r[:, c * q ** dim:(c + 1) * q ** dim]
                            .reshape(n + (q,) * dim).permute(inverse_perm(perm)),
                            dim, n, p)
            for c in range(dim)])

    def apply_bilinear(self, um: torch.Tensor) -> torch.Tensor:
        return {"kron": self.apply_kron, "dense": self.apply_dense,
                "sumfac": self.apply_sumfac}[self.variant](um)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """Full vmult with constrained-DoF semantics, component by component:
        A_eff = M A M + (I - M)."""
        u = u.reshape(self.shape)
        m = self.mask
        au = self.apply_bilinear(u * m)
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
                            lam: float, m1, gK, gM, variant: str = "kron",
                            K1=None, M1=None, G1=None, B=None, Dco=None,
                            qmetric=None, elem_matrix=None,
                            dtype=torch.float64,
                            device="cpu") -> ElasticityOperator:
    """Pack an operator from its state (NumPy, float64): the 1D mask and
    diagonal factors, and the variant's own (``K1``, ``M1``, ``G1`` for
    kron; ``B``, ``Dco``, ``qmetric`` for sumfac; ``elem_matrix`` for
    dense), the same on every axis."""
    def axes(a):
        return None if a is None else (to_tensor(a, dtype, device),) * dim

    whole = {k: None if a is None else to_tensor(a, dtype, device)
             for k, a in dict(B=B, Dco=Dco, qmetric=qmetric,
                              elem_matrix=elem_matrix).items()}
    return ElasticityOperator(dim=dim, degree=degree, n=(n,) * dim,
                              mu=float(mu), lam=float(lam), mask1=axes(m1),
                              dK1=axes(gK), dM1=axes(gM), variant=variant,
                              Kg=axes(K1), Mg=axes(M1), Gg=axes(G1), **whole)


def make_elasticity(space: FESpace, dtype=torch.float64, mu: float = 1.0,
                    lam: float = 1.0, variant: str = "kron",
                    device="cpu") -> ElasticityOperator:
    """Build the ``"kron"``, ``"sumfac"`` or ``"dense"`` elasticity operator
    of a space on ``device``."""
    state = {}
    if variant == "kron":
        K1, M1 = assembled_1d_matrices(space)
        state.update(K1=K1, M1=M1, G1=assembled_1d_gradient(space))
    elif variant == "sumfac":
        b = space.basis
        state.update(B=b.B, Dco=b.Dco, qmetric=quadrature_metric(space))
    elif variant == "dense":
        state["elem_matrix"] = element_stiffness_elasticity(
            space.degree, space.dim, space.mesh.h, mu, lam)
    else:
        reject_variant(variant)
    gK, gM = diagonal_1d_factors(space)
    return elasticity_from_factors(
        dim=space.dim, degree=space.degree, n=space.mesh.cells_per_axis,
        mu=mu, lam=lam, m1=space.free_mask_1d(), gK=gK, gM=gM,
        variant=variant, dtype=dtype, device=device, **state)
