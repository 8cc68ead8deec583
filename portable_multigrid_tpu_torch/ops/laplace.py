"""Matrix-free Laplace operator on a structured Q_p space (plain torch).

Counterpart of ``portable_multigrid_tpu/ops/laplace.py``.  Constrained-DoF
semantics are the reference's: A_eff = M A M + (I - M) with M the separable
Dirichlet grid mask (reference:
include/operators/portable_laplace_operator.h:557-719).  The variants
compute the same assembled Galerkin operator (same quadrature):

  * ``"kron"`` — on a tensor-product mesh with Cartesian geometry
    A = Kx (x) My (x) Mz + Mx (x) Ky (x) Mz + Mx (x) My (x) Kz with banded
    assembled 1D stiffness/mass matrices: a handful of 1D contractions on
    the contiguous DoF grid;
  * ``"sumfac"`` — gather to the interleaved element layout, the
    reference's five cell stages (basis change to the quadrature points,
    collocation gradients, q-point weights, transposed gradients, basis
    change back; reference: portable_laplace_operator.h:281-357), and the
    overlap-add scatter, with an optional coefficient c(x) folded into the
    q-point weights;
  * ``"dense"`` — the element loop as one product with the constant
    element matrix;
  * ``"qdense"`` (a coefficient only) — the element loop as two products
    with the element gradient matrix around a per-element q-point scale;
  * ``"qbanded"`` (a coefficient only) — the q-point stages hoisted to the
    contiguous grid: interpolation to the quadrature points is a window
    split then B per axis, its transpose B^T then an overlap-add, and the
    collocation derivative a per-cell Dco.

Gather and scatter are reshapes, slices and overlap-adds (``structured.py``):
no indexed scatter, deterministic by construction.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fem.assemble import element_stiffness_cartesian, quad_grid_1d
from ..fem.basis import make_basis
from ..fem.space import FESpace
from .structured import (
    contract,
    matmul,
    overlap_add,
    overlap_add_all,
    split_all,
    split_windows,
)

# variants of the JAX package that the port does not carry, with the reason
_LATER_VARIANTS = {
    "bkron": "ROADMAP queue B 'not to port' (TPU-only: MXU block packing)",
}

def reject_variant(variant: str) -> None:
    """Raise for a variant the port does not carry."""
    if variant in _LATER_VARIANTS:
        raise ValueError(f"operator variant {variant!r} is not ported: "
                         f"{_LATER_VARIANTS[variant]}")
    raise ValueError(f"unknown operator variant: {variant!r}")


def bcast(v: torch.Tensor, ax: int, dim: int) -> torch.Tensor:
    """Reshape a per-axis 1D factor for broadcasting onto a dim-D grid; a
    factor of more dimensions comes shaped for it (a batch of slabs'
    factors, ``parallel/sharding.py``) and is returned as it is."""
    if v.ndim > 1:
        return v
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


def interleaved_shape(n: tuple, nq: int) -> tuple:
    """The interleaved element layout [n_0, nq, n_1, nq, ...] of a
    [n_0*nq, n_1*nq, ...] quadrature grid."""
    return tuple(x for nd in n for x in (nd, nq))


# the element-first order of the interleaved layout, and its inverse
def element_perm(dim: int) -> tuple:
    return tuple(range(0, 2 * dim, 2)) + tuple(range(1, 2 * dim, 2))


def inverse_perm(perm: tuple) -> tuple:
    return tuple(int(i) for i in np.argsort(perm))


@dataclasses.dataclass
class LaplaceOperator:
    """Matrix-free Laplace operator holding its state as tensors; the
    fields a variant does not use stay None."""

    dim: int
    degree: int
    n: tuple  # cells per axis
    mask1: tuple  # per-axis [N_d] free-DoF mask factors
    variant: str = "kron"
    dK1: tuple = None  # per-axis assembled 1D stiffness diagonals (h-folded)
    dM1: tuple = None  # per-axis assembled 1D mass diagonals
    Kg: tuple = None  # per-axis assembled 1D stiffness [N_d, N_d] ("kron")
    Mg: tuple = None  # per-axis assembled 1D mass [N_d, N_d] ("kron")
    B: torch.Tensor = None  # [nq, p+1] shape values at the quadrature points
    Dco: torch.Tensor = None  # [nq, nq] collocation derivative
    qmetric: torch.Tensor = None  # [nq]^dim: w_q (x) ... (x) w_q h^(dim-2)
    # coefficient c(x) at the quadrature points, [n_0*nq, n_1*nq, ...]
    # ("sumfac", "qbanded"); None = unit coefficient
    coef: torch.Tensor = None
    # the inverse diagonal of a variable-coefficient operator, which is not
    # separable, stored whole
    inv_diag_full: torch.Tensor = None
    elem_matrix: torch.Tensor = None  # [(p+1)^dim]^2 ("dense")
    # "qdense": the element gradient operator [(p+1)^dim, dim nq^dim]
    # (column block d: kron over axes of Dco@B if a == d else B) and the
    # per-element q-point weights w_q h^(dim-2) c(x_q), [E, nq^dim]
    Gmat: torch.Tensor = None
    wcoef_e: torch.Tensor = None

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
        if self.inv_diag_full is not None:
            return self.inv_diag_full
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

    def _weights(self) -> torch.Tensor:
        """q-point weights in the interleaved layout: the metric, times
        the coefficient where there is one."""
        nq = self.B.shape[0]
        w = self.qmetric.reshape(tuple(1 if a % 2 == 0 else nq
                                       for a in range(2 * self.dim)))
        if self.coef is not None:
            w = w * self.coef.reshape(interleaved_shape(self.n, nq))
        return w

    def apply_local(self, ue: torch.Tensor) -> torch.Tensor:
        """Element-local weak Laplacian on the interleaved split tensor (cell
        axes even, DoF axes odd): the five stages of the reference cell
        kernel (portable_laplace_operator.h:281-357)."""
        qaxes = [2 * d + 1 for d in range(self.dim)]
        # 1. basis change to the quadrature collocation space
        v = ue
        for ax in qaxes:
            v = contract(v, self.B, ax)
        # 2. collocation gradients, 3. q-point weights, 4. transposed
        # gradients
        w = self._weights()
        r = None
        for ax in qaxes:
            g = contract(contract(v, self.Dco, ax) * w, self.Dco.T, ax)
            r = g if r is None else r + g
        # 5. basis change back
        for ax in qaxes:
            r = contract(r, self.B.T, ax)
        return r

    def _to_elements(self, ue: torch.Tensor) -> torch.Tensor:
        """Interleaved layout -> [E, (p+1)^dim], one row per element."""
        q = self.degree + 1
        return ue.permute(element_perm(self.dim)).reshape(-1, q ** self.dim)

    def _from_elements(self, flat: torch.Tensor) -> torch.Tensor:
        """[E, (p+1)^dim] -> interleaved layout."""
        q = self.degree + 1
        return flat.reshape(tuple(self.n) + (q,) * self.dim).permute(
            inverse_perm(element_perm(self.dim)))

    def apply_local_dense(self, ue: torch.Tensor) -> torch.Tensor:
        """The element loop as one [E, (p+1)^dim] @ [(p+1)^dim]^2 product
        with the constant element matrix (every cell's is the same on the
        uniformly refined affine mesh).

        The product runs in difference form, A_loc (u_e - u_e[0]): the
        element matrix annihilates constants, and the differences of a
        smooth u are O(h) where its values are O(1), so float32 keeps the
        smooth component that the direct sum loses to cancellation
        (tests/test_torch_sumfac.py)."""
        flat = self._to_elements(ue)
        return self._from_elements(matmul(flat - flat[:, :1],
                                          self.elem_matrix))

    def apply_local_qdense(self, ue: torch.Tensor) -> torch.Tensor:
        """Variable-coefficient element apply as two products: all dim
        gradient components at all q points of every element,
        [E, (p+1)^dim] @ [(p+1)^dim, dim nq^dim], the q-point scale by
        ``wcoef_e``, and the mirrored product with G^T."""
        dim, w = self.dim, self.wcoef_e
        nqd = w.shape[1]
        g = matmul(self._to_elements(ue), self.Gmat)
        g = (g.reshape(-1, dim, nqd) * w[:, None, :]).reshape(-1, dim * nqd)
        return self._from_elements(matmul(g, self.Gmat.T))

    def _cellwise(self, t: torch.Tensor, M: torch.Tensor,
                  ax: int) -> torch.Tensor:
        """Apply the per-cell [nq, nq] matrix M along quadrature-grid axis
        ``ax`` (length n*nq): the block-diagonal Dg of the JAX package."""
        shp = tuple(t.shape)
        nq = M.shape[0]
        t = t.reshape(shp[:ax] + (self.n[ax], nq) + shp[ax + 1:])
        return contract(t, M, ax + 1).reshape(shp)

    def apply_qbanded(self, um: torch.Tensor) -> torch.Tensor:
        """Variable-coefficient apply on the contiguous grids: per axis the
        interpolation to the quadrature grid (window split, then B), per
        direction the collocation derivative, the q-point weights and the
        transposed derivative, then per axis B^T and the overlap-add.  The
        arithmetic of ``apply_local``, reordered."""
        dim, p = self.dim, self.degree
        nq = self.B.shape[0]
        v = um
        for ax in range(dim):
            v = contract(split_windows(v, ax, self.n[ax], p), self.B, ax + 1)
            v = v.reshape(v.shape[:ax] + (-1,) + v.shape[ax + 2:])
        wq = torch.broadcast_to(self._weights(),
                                interleaved_shape(self.n, nq)).reshape(v.shape)
        r = None
        for d in range(dim):
            g = self._cellwise(self._cellwise(v, self.Dco, d) * wq,
                               self.Dco.T, d)
            r = g if r is None else r + g
        for ax in range(dim):
            shp = tuple(r.shape)
            r = r.reshape(shp[:ax] + (self.n[ax], nq) + shp[ax + 1:])
            r = overlap_add(contract(r, self.B.T, ax + 1), ax, self.n[ax], p)
        return r

    def apply_bilinear(self, um: torch.Tensor) -> torch.Tensor:
        """Gather, element apply and scatter, without the constraint masks."""
        if self.variant == "kron":
            return self.apply_kron(um)
        if self.variant == "qbanded":
            return self.apply_qbanded(um)
        local = {"dense": self.apply_local_dense,
                 "qdense": self.apply_local_qdense}.get(self.variant,
                                                        self.apply_local)
        ue = split_all(um, self.dim, self.n, self.degree)
        return overlap_add_all(local(ue), self.dim, self.n, self.degree)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """Full vmult with constrained-DoF semantics: A_eff = M A M + (I - M)."""
        u = u.reshape(self.grid_shape)
        m = self.mask
        au = self.apply_bilinear(u * m)
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


def quadrature_metric(space: FESpace) -> np.ndarray:
    """[nq]^dim: w_q (x) ... (x) w_q h^(dim-2), the Cartesian metric."""
    qm = np.array(1.0)
    for _ in range(space.dim):
        qm = np.multiply.outer(qm, space.basis.q_weights)
    return qm * space.mesh.h ** (space.dim - 2)


def global_quad_matrices(space: FESpace) -> tuple[np.ndarray, np.ndarray]:
    """The per-axis quadrature stages as global matrices (NumPy): Bg
    [n*nq, N] maps the nodal grid to the quadrature grid (the cell-block
    stack of B, one shared column per cell boundary) and Dg [n*nq, n*nq] is
    the block-diagonal collocation derivative.  ``apply_qbanded`` applies
    them as window contractions; the tests hold those against these."""
    b = space.basis
    n, p, nq = space.mesh.cells_per_axis, space.degree, b.n_q
    Bg = np.zeros((n * nq, space.points_per_axis))
    Dg = np.zeros((n * nq, n * nq))
    for c in range(n):
        Bg[c * nq:(c + 1) * nq, c * p:c * p + p + 1] = b.B
        Dg[c * nq:(c + 1) * nq, c * nq:(c + 1) * nq] = b.Dco
    return Bg, Dg


def grad_matrix(B: np.ndarray, Dco: np.ndarray, dim: int) -> np.ndarray:
    """Dense element gradient operator [(p+1)^dim, dim*nq^dim] (NumPy):
    column block d maps the nodal element DoFs to the d-derivative at every
    quadrature point, kron over axes of (Dco @ B if a == d else B) — the
    factors of ``apply_local``'s stages 1 and 2."""
    DB = Dco @ B
    blocks = []
    for d in range(dim):
        G = np.array([[1.0]])
        for a in range(dim):
            G = np.kron(G, DB if a == d else B)
        blocks.append(G)  # [nq^dim, (p+1)^dim]
    return np.concatenate(blocks, axis=0).T


def coef_at_quad(space: FESpace, coefficient) -> np.ndarray:
    """A coefficient callable sampled at every quadrature point:
    [n*nq]^dim (NumPy, float64)."""
    x1 = quad_grid_1d(space)
    coords = np.meshgrid(*([x1] * space.dim), indexing="ij")
    return np.asarray(coefficient(*coords), dtype=np.float64)


def element_weights(space: FESpace, coef: torch.Tensor) -> torch.Tensor:
    """``qdense``'s per-element q-point weights [E, nq^dim]: the coefficient
    grid in element order, times the quadrature metric."""
    dim, nq, n = space.dim, space.basis.n_q, space.mesh.cells_per_axis
    ce = coef.reshape(interleaved_shape((n,) * dim, nq))
    ce = ce.permute(element_perm(dim)).reshape(n ** dim, nq ** dim)
    qm = torch.as_tensor(quadrature_metric(space), dtype=coef.dtype,
                         device=coef.device)
    return ce * qm.reshape(1, -1)


def diagonal_grid_coef(space: FESpace, coef: torch.Tensor) -> torch.Tensor:
    """Matrix diagonal for a variable scalar coefficient, constrained DoFs
    1: d_i = sum_q c_q w_q h^(dim-2) |grad phi_i(q)|^2.  The squared
    gradient factorizes per axis, so this is a sum-factorized contraction of
    the coefficient grid with squared 1D matrices, then the overlap-add; it
    runs where ``coef`` lies, in its dtype."""
    b = make_basis(space.degree)
    p, nq, n, dim = space.degree, b.n_q, space.mesh.cells_per_axis, space.dim

    def t(a):
        return torch.as_tensor(a, dtype=coef.dtype, device=coef.device)

    # [i, q] with the axis's quadrature weight folded in
    B2 = t((b.B ** 2 * b.q_weights[:, None]).T)
    D2 = t((b.D ** 2 * b.q_weights[:, None]).T)
    diag = None
    for k in range(dim):
        g = coef
        for ax in range(dim):
            shp = tuple(g.shape)
            g = g.reshape(shp[:ax] + (n, nq) + shp[ax + 1:])
            g = overlap_add(contract(g, D2 if ax == k else B2, ax + 1), ax,
                            n, p)
        diag = g if diag is None else diag + g
    m = t(space.free_mask())
    return diag * space.mesh.h ** (dim - 2) * m + (1.0 - m)


def make_laplace(space: FESpace, dtype=torch.float64, variant: str = "kron",
                 device="cpu", coefficient=None) -> LaplaceOperator:
    """Build the operator of a space on ``device``.

    Without a coefficient: ``"kron"``, ``"sumfac"`` or ``"dense"``.  With a
    coefficient c(x) (a callable of dim coordinate arrays) the operator is
    a(u, v) = ∫ c grad u . grad v: ``"auto"`` and ``"qdense"`` give
    ``"qdense"``, and ``"sumfac"`` and ``"qbanded"`` are kept; its diagonal
    is stored whole."""
    dim, b = space.dim, space.basis

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    fields = {}
    if coefficient is not None:
        if variant in ("auto", "qdense"):
            variant = "qdense"
        elif variant not in ("sumfac", "qbanded"):
            raise ValueError("variable coefficients require the 'sumfac', "
                             "'qdense' or 'qbanded' variant")
        # the setup runs in float64 on the operator's device
        coef = torch.as_tensor(coef_at_quad(space, coefficient),
                               dtype=torch.float64, device=device)
        fields["inv_diag_full"] = t(1.0 / diagonal_grid_coef(space, coef))
        if variant == "qdense":
            fields.update(Gmat=t(grad_matrix(b.B, b.Dco, dim)),
                          wcoef_e=t(element_weights(space, coef)))
        else:
            fields["coef"] = t(coef)
    elif variant in ("qdense", "qbanded"):
        raise ValueError(f"operator variant {variant!r} needs a coefficient")
    else:
        gK, gM = diagonal_1d_factors(space)
        fields.update(dK1=(t(gK),) * dim, dM1=(t(gM),) * dim)
    if variant == "kron":
        K1, M1 = assembled_1d_matrices(space)
        fields.update(Kg=(t(K1),) * dim, Mg=(t(M1),) * dim)
    elif variant == "dense":
        fields["elem_matrix"] = t(element_stiffness_cartesian(
            space.degree, dim, space.mesh.h))
    elif variant in ("sumfac", "qbanded"):
        fields.update(B=t(b.B), Dco=t(b.Dco),
                      qmetric=t(quadrature_metric(space)))
    elif variant != "qdense":
        reject_variant(variant)
    return LaplaceOperator(
        dim=dim, degree=space.degree, n=(space.mesh.cells_per_axis,) * dim,
        mask1=(t(space.free_mask_1d()),) * dim, variant=variant, **fields)
