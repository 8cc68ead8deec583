"""1D Lagrange bases, quadrature, and shape matrices (host-side, NumPy).

A NumPy copy of ``portable_multigrid_tpu/fem/basis.py`` (that package imports
JAX eagerly, and the port never imports JAX); kept bit-equal by
tests/test_torch_fem.py.

TPU-native equivalent of the 1D data consumed by the reference's
sum-factorization evaluator: ``shape_values``, ``shape_gradients`` and
``co_shape_gradients`` (reference: include/operators/portable_laplace_operator.h:92-102
consumes them via deal.II's ``internal::EvaluatorTensorProduct``), plus the 1D
transfer matrices built from ``fe.get_prolongation_matrix(child)``
(reference: include/multigrid/portable_geometric_transfer.h:1303-1318) and
``FETools::get_projection_matrix`` (reference:
include/multigrid/portable_polynomial_tranfer.h:957-961).

Everything here is setup-time NumPy in float64; the arrays are later cast to
the compute dtype and shipped to the device once.

Conventions:
  * all 1D geometry lives on the unit interval [0, 1];
  * nodal points of Q_p are the (p+1) Gauss–Lobatto points (deal.II FE_Q
    support points), ordered lexicographically left→right — no hierarchical→
    lexicographic renumbering step is ever needed (the reference must renumber,
    e.g. include/multigrid/portable_geometric_transfer.h:1275-1284);
  * quadrature is Gauss–Legendre with (p+1) points (QGauss(p+1), reference:
    include/operators/portable_laplace_operator.h:469-482).
"""

from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np


def gauss_points(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss–Legendre rule on [0, 1]: (points, weights)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def gauss_lobatto_points(n: int) -> np.ndarray:
    """n Gauss–Lobatto points on [0, 1] (n >= 2), endpoints included."""
    if n < 2:
        raise ValueError("Gauss-Lobatto needs at least 2 points")
    if n == 2:
        return np.array([0.0, 1.0])
    # interior points are roots of P'_{n-1}
    coeffs = np.zeros(n)
    coeffs[n - 1] = 1.0
    interior = np.polynomial.legendre.legroots(np.polynomial.legendre.legder(coeffs))
    pts = np.concatenate([[-1.0], interior, [1.0]])
    return 0.5 * (pts + 1.0)


def _barycentric_weights(nodes: np.ndarray) -> np.ndarray:
    diff = nodes[:, None] - nodes[None, :]
    np.fill_diagonal(diff, 1.0)
    return 1.0 / np.prod(diff, axis=1)


def lagrange_eval(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Evaluation matrix V[a, j] = l_j(x[a]) of the Lagrange basis on `nodes`.

    Barycentric form, exact (0/1) when an evaluation point hits a node.
    """
    nodes = np.asarray(nodes, dtype=np.float64)
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    w = _barycentric_weights(nodes)
    diff = x[:, None] - nodes[None, :]  # [nx, nn]
    exact = np.isclose(diff, 0.0, rtol=0.0, atol=1e-14)
    safe = np.where(exact, 1.0, diff)
    terms = w[None, :] / safe
    denom = np.sum(np.where(exact, 0.0, terms), axis=1, keepdims=True)
    hit_rows = exact.any(axis=1)
    denom[hit_rows] = 1.0  # dummy; rows overwritten below
    V = terms / denom
    V[hit_rows] = exact[hit_rows].astype(np.float64)
    return V


def diff_matrix(nodes: np.ndarray) -> np.ndarray:
    """Spectral differentiation matrix D[i, j] = l_j'(nodes[i])."""
    nodes = np.asarray(nodes, dtype=np.float64)
    n = len(nodes)
    w = _barycentric_weights(nodes)
    D = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if i != j:
                D[i, j] = (w[j] / w[i]) / (nodes[i] - nodes[j])
        D[i, i] = -np.sum(D[i, :])
    return D


def lagrange_deriv(nodes: np.ndarray, x: np.ndarray) -> np.ndarray:
    """Derivative matrix G[a, j] = l_j'(x[a]) at arbitrary points.

    Computed exactly as (evaluate at x) ∘ (differentiate at nodes): l_j' is a
    polynomial of degree p-1 fully determined by its values at the nodes.
    """
    return lagrange_eval(nodes, x) @ diff_matrix(nodes)


@dataclasses.dataclass(frozen=True)
class Basis1D:
    """All 1D shape data for one polynomial degree.

    Attributes
    ----------
    degree : p
    nodes : (p+1,) Gauss–Lobatto nodal points on [0, 1]
    q_points, q_weights : (p+1,) Gauss–Legendre quadrature on [0, 1]
    B : (nq, p+1) shape values at quadrature points   [phi_j(x_q)]
    D : (nq, p+1) shape gradients at quadrature points [phi_j'(x_q)]
    Dco : (nq, nq) collocation derivative: Lagrange basis ON the quadrature
          points differentiated at the quadrature points (the reference's
          ``co_shape_gradients``; the identity D = Dco @ B makes the
          collocation-space evaluation exactly equivalent to direct gradients).
    """

    degree: int
    nodes: np.ndarray
    q_points: np.ndarray
    q_weights: np.ndarray
    B: np.ndarray
    D: np.ndarray
    Dco: np.ndarray

    @property
    def n_dofs(self) -> int:
        return self.degree + 1

    @property
    def n_q(self) -> int:
        return len(self.q_points)


@lru_cache(maxsize=None)
def make_basis(degree: int, n_q: int | None = None) -> Basis1D:
    """Build the Basis1D for ``degree`` with ``n_q`` Gauss points (default p+1)."""
    if degree < 1:
        raise ValueError("degree must be >= 1")
    nodes = gauss_lobatto_points(degree + 1)
    nq = n_q if n_q is not None else degree + 1
    qp, qw = gauss_points(nq)
    B = lagrange_eval(nodes, qp)
    D = lagrange_deriv(nodes, qp)
    Dco = diff_matrix(qp)
    return Basis1D(degree, nodes, qp, qw, B, D, Dco)


# --------------------------------------------------------------------------
# 1D transfer matrices
# --------------------------------------------------------------------------


def h_prolongation_matrix_1d(degree: int) -> np.ndarray:
    """Combined two-child 1D embedding matrix, shape (2p+1, p+1).

    Row r is the evaluation of the coarse Lagrange basis at the r-th fine
    nodal point of the refined pair of children; the shared center row is
    identical from both children.  TPU-native equivalent of assembling
    ``fe.get_prolongation_matrix(child)`` into the (p+1) x (2p+1) scheme
    matrix (reference: include/multigrid/portable_geometric_transfer.h:1290-1318,
    with n_child_dofs_1d = 2*(p+1) - 1).
    """
    nodes = gauss_lobatto_points(degree + 1)
    p = degree
    fine_pts = np.concatenate([0.5 * nodes, 0.5 + 0.5 * nodes[1:]])  # 2p+1 points
    return lagrange_eval(nodes, fine_pts)


def p_prolongation_matrix_1d(p_coarse: int, p_fine: int) -> np.ndarray:
    """1D degree-embedding matrix, shape (p_fine+1, p_coarse+1).

    Since Q_{p_coarse} ⊂ Q_{p_fine}, the L2 projection used by the reference
    (``FETools::get_projection_matrix``, reference:
    include/multigrid/portable_polynomial_tranfer.h:957-961) coincides with
    nodal interpolation of the coarse basis at the fine nodal points, which is
    what we build directly.
    """
    if p_fine < p_coarse:
        raise ValueError("p_fine must be >= p_coarse")
    coarse_nodes = gauss_lobatto_points(p_coarse + 1)
    fine_nodes = gauss_lobatto_points(p_fine + 1)
    return lagrange_eval(coarse_nodes, fine_nodes)
