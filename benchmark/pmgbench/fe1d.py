"""One-dimensional Q_p data on a uniform mesh of [0, 1] (NumPy, float64).

The benchmark's own copy of the little finite-element arithmetic that its
traffic generator and its plain reference need: the Gauss-Lobatto nodes of
Q_p (deal.II's ``FE_Q`` support points), Gauss-Legendre quadrature, the
Lagrange basis and its derivative at arbitrary points, the assembled 1D
stiffness, mass and gradient matrices and the assembled 1D load vector of
a function.
It imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np


def gauss(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The n-point Gauss-Legendre rule on [0, 1]: (points, weights)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def lobatto_nodes(degree: int) -> np.ndarray:
    """The degree + 1 Gauss-Lobatto points on [0, 1], ends included."""
    c = np.zeros(degree + 1)
    c[degree] = 1.0
    inner = np.sort(np.polynomial.legendre.legroots(
        np.polynomial.legendre.legder(c)))
    return 0.5 * (np.concatenate([[-1.0], inner, [1.0]]) + 1.0)


def lagrange(nodes: np.ndarray, x: np.ndarray) -> tuple[np.ndarray,
                                                        np.ndarray]:
    """Values V[a, j] = l_j(x_a) and derivatives G[a, j] = l_j'(x_a) of the
    Lagrange basis on ``nodes``, by the product formula (x off the nodes,
    as quadrature points are)."""
    n = len(nodes)
    V = np.ones((len(x), n))
    G = np.zeros((len(x), n))
    for j in range(n):
        others = [m for m in range(n) if m != j]
        den = np.prod([nodes[j] - nodes[m] for m in others])
        for a, xa in enumerate(x):
            terms = [xa - nodes[m] for m in others]
            V[a, j] = np.prod(terms) / den
            G[a, j] = sum(np.prod(terms[:k] + terms[k + 1:])
                          for k in range(len(terms))) / den
    return V, G


def n_points(degree: int, refinements: int) -> int:
    """DoF points per axis: 2^refinements cells of degree + 1 nodes each,
    neighbours sharing their end nodes."""
    return (1 << refinements) * degree + 1


def assembled_matrices(degree: int, refinements: int) -> tuple[np.ndarray,
                                                               np.ndarray]:
    """Dense assembled 1D stiffness K[i, j] = int l_i' l_j' and mass
    M[i, j] = int l_i l_j over 2^refinements equal cells of [0, 1], each
    integrated with degree + 2 Gauss points (exact for both)."""
    n = 1 << refinements
    h = 1.0 / n
    q, w = gauss(degree + 2)
    V, G = lagrange(lobatto_nodes(degree), q)
    Kc = (G.T * w) @ G / h
    Mc = (V.T * w) @ V * h
    return (_assemble(Kc, degree, refinements),
            _assemble(Mc, degree, refinements))


def assembled_gradient(degree: int, refinements: int) -> np.ndarray:
    """Dense assembled 1D gradient matrix C[i, j] = int l_i l_j' over
    2^refinements equal cells of [0, 1], each integrated with degree + 2
    Gauss points (exact): the coupling of two axes' derivatives that linear
    elasticity needs beside K and M.  The 1/h of l_j' cancels the h of
    dx, so the cell matrix is the reference cell's."""
    q, w = gauss(degree + 2)
    V, G = lagrange(lobatto_nodes(degree), q)
    return _assemble((V.T * w) @ G, degree, refinements)


def _assemble(cell: np.ndarray, degree: int, refinements: int) -> np.ndarray:
    """The dense 1D matrix of 2^refinements copies of the cell matrix
    ``cell``, neighbours sharing their end nodes."""
    N = n_points(degree, refinements)
    A = np.zeros((N, N))
    for c in range(1 << refinements):
        s = slice(c * degree, c * degree + degree + 1)
        A[s, s] += cell
    return A


def load_vector(degree: int, refinements: int, g, n_q: int | None = None
                ) -> np.ndarray:
    """The assembled 1D load vector v_i = int l_i g over [0, 1] with
    ``n_q`` (default degree + 1) Gauss points a cell, the rule of the
    reference program's right-hand side; ``g`` maps an array of points to
    values."""
    n = 1 << refinements
    h = 1.0 / n
    q, w = gauss(degree + 1 if n_q is None else n_q)
    V, _ = lagrange(lobatto_nodes(degree), q)
    x = (np.arange(n)[:, None] + q[None, :]) * h  # [cell, q]
    per_cell = (np.asarray(g(x), np.float64) * w * h) @ V  # [cell, p + 1]
    v = np.zeros(n_points(degree, refinements))
    for i in range(degree + 1):
        v[i:i + n * degree:degree] += per_cell[:, i]
    return v


def free_mask(degree: int, refinements: int) -> np.ndarray:
    """1 on the free points of an axis, 0 on its two Dirichlet ends."""
    m = np.ones(n_points(degree, refinements))
    m[0] = m[-1] = 0.0
    return m
