"""Host-side RHS / L2 functionals and dense test oracles (NumPy).

The subset of ``portable_multigrid_tpu/fem/assemble.py`` that the geometric
multigrid solve and its tests need, copied so the port never imports the JAX
package:

  * :func:`assemble_rhs` and :func:`l2_norm` — the reference driver's RHS
    quadrature loop and ``integrate_difference`` L2 norm (reference:
    source/geometric_multigrid/program.cc:291-334,382-395);
  * :func:`dense_operator`, :func:`dense_operator_coefficient` and
    :func:`dense_prolongation` — dense golden assemblies that the tests hold
    the matrix-free operators against.
"""

from __future__ import annotations

import numpy as np

from .basis import make_basis
from .space import FESpace


def split_windows_np(u: np.ndarray, axis: int, n: int, stride: int, width: int):
    """Overlapping windows along ``axis``: grid length n*stride+1 -> [n, width]."""
    u = np.moveaxis(u, axis, 0)
    idx = np.arange(n)[:, None] * stride + np.arange(width)[None, :]
    out = u[idx]  # [n, width, ...]
    return np.moveaxis(np.moveaxis(out, 1, -1), 0, axis)


def overlap_add_np(v: np.ndarray, axis: int, n: int, stride: int, width: int):
    """Transpose of split_windows_np: [n(axis), ..., width(last)] -> grid."""
    v = np.moveaxis(np.moveaxis(v, axis, 0), -1, 1)  # [n, width, ...]
    N = n * stride + 1
    out = np.zeros((N,) + v.shape[2:], dtype=v.dtype)
    idx = np.arange(n)[:, None] * stride + np.arange(width)[None, :]
    np.add.at(out, idx.reshape(-1), v.reshape((n * width,) + v.shape[2:]))
    return np.moveaxis(out, 0, axis)


def element_stiffness_cartesian(degree: int, dim: int, h: float) -> np.ndarray:
    """Exact Q_p element stiffness matrix on a Cartesian cell of size h^dim:
    A = h^(dim-2) * sum_k M x ... K(at k) ... x M (1D Gauss-quadrature
    mass-like and stiffness-like matrices)."""
    b = make_basis(degree)
    W = np.diag(b.q_weights)
    M1 = b.B.T @ W @ b.B
    K1 = b.D.T @ W @ b.D
    mats = []
    for k in range(dim):
        factors = [K1 if m == k else M1 for m in range(dim)]
        acc = factors[0]
        for f in factors[1:]:
            acc = np.kron(acc, f)
        mats.append(acc)
    return h ** (dim - 2) * sum(mats)


def gradient_matrices(degree: int, dim: int) -> list[np.ndarray]:
    """Reference-cell gradient matrices G_k[Q, ndof] (lexicographic, axis 0
    slowest), for dense golden assemblies."""
    b = make_basis(degree)
    mats = []
    for k in range(dim):
        G = np.array([[1.0]])
        for m in range(dim):
            G = np.kron(G, b.D if m == k else b.B)
        mats.append(G)
    return mats


def dense_operator(space: FESpace) -> np.ndarray:
    """Dense global operator with the reference's constrained-DoF semantics:
    A_eff = M A M + (I - M), M = diag(free mask) (reference:
    include/operators/portable_laplace_operator.h:245-258,361-380,718)."""
    A_loc = element_stiffness_cartesian(space.degree, space.dim, space.mesh.h)
    l2g = space.local_to_global()
    N = space.n_dofs
    A = np.zeros((N, N))
    for e in range(l2g.shape[0]):
        idx = l2g[e]
        A[np.ix_(idx, idx)] += A_loc
    m = space.free_mask().reshape(-1)
    A = A * m[:, None] * m[None, :]
    A[np.arange(N), np.arange(N)] += 1.0 - m
    return A


def dense_operator_coefficient(space: FESpace, coefficient) -> np.ndarray:
    """Dense golden operator for a variable scalar coefficient c(x):
    a(u,v) = ∫ c grad u . grad v, with the constrained-DoF semantics of
    :func:`dense_operator`.  Tiny meshes only (a Python cell loop)."""
    from .basis import gauss_points

    dim, p = space.dim, space.degree
    h = space.mesh.h
    n = space.mesh.cells_per_axis
    G = gradient_matrices(p, dim)
    qp, qw = gauss_points(p + 1)
    wq = np.array([1.0])
    for _ in range(dim):
        wq = np.kron(wq, qw)
    l2g = space.local_to_global()
    N = space.n_dofs
    A = np.zeros((N, N))
    for e in range(l2g.shape[0]):
        cell = np.unravel_index(e, (n,) * dim)
        # physical coordinates of this cell's quadrature points
        axes = [space.mesh.a + h * (c + qp) for c in cell]
        coords = np.meshgrid(*axes, indexing="ij")
        cq = np.asarray(coefficient(*coords), dtype=np.float64).reshape(-1)
        W = cq * wq * h ** (dim - 2)
        idx = l2g[e]
        A[np.ix_(idx, idx)] += sum((Gk * W[:, None]).T @ Gk for Gk in G)
    m = space.free_mask().reshape(-1)
    A = A * m[:, None] * m[None, :]
    A[np.arange(N), np.arange(N)] += 1.0 - m
    return A


def dense_prolongation(coarse: FESpace, fine: FESpace) -> np.ndarray:
    """Dense global prolongation P[fine_dof, coarse_dof] with boundary masking,
    built by interpolating the coarse piecewise basis at the fine grid points
    (reference: include/multigrid/portable_geometric_transfer.h:170-173,
    1345-1351)."""
    from .basis import lagrange_eval

    def p1d(cs: FESpace, fs: FESpace) -> np.ndarray:
        xc = cs.dof_points_1d()
        xf = fs.dof_points_1d()
        nc = cs.mesh.cells_per_axis
        pc = cs.degree
        hc = cs.mesh.h
        P = np.zeros((len(xf), len(xc)))
        nodes = cs.basis.nodes
        for i, x in enumerate(xf):
            c = min(int((x - cs.mesh.a) / hc), nc - 1)
            xi = (x - (cs.mesh.a + c * hc)) / hc
            vals = lagrange_eval(nodes, np.array([xi]))[0]
            P[i, c * pc : c * pc + pc + 1] += vals
        return P

    P1 = p1d(coarse, fine)
    P = P1
    for _ in range(coarse.dim - 1):
        P = np.kron(P, P1)
    mf = fine.free_mask().reshape(-1)
    mc = coarse.free_mask().reshape(-1)
    return P * mf[:, None] * mc[None, :]


def quad_grid_1d(space: FESpace, n_q: int | None = None) -> np.ndarray:
    """Physical coordinates of all quadrature points along one axis [n*nq]."""
    from .basis import gauss_points

    nq = n_q if n_q is not None else space.degree + 1
    qp, _ = gauss_points(nq)
    n = space.mesh.cells_per_axis
    h = space.mesh.h
    return (space.mesh.a + h * (np.arange(n)[:, None] + qp[None, :])).reshape(-1)


def assemble_rhs(space: FESpace, f=None, n_q: int | None = None) -> np.ndarray:
    """Assemble rhs_i = ∫ phi_i f dx on the DoF grid, masked on constraints.

    f: callable taking dim coordinate arrays (broadcastable) -> values; None
    means f ≡ 1 (the reference driver's RHS, reference:
    source/geometric_multigrid/program.cc:317-325).
    """
    from .basis import gauss_points, lagrange_eval

    p = space.degree
    nq = n_q if n_q is not None else p + 1
    qp, qw = gauss_points(nq)
    B = lagrange_eval(space.basis.nodes, qp)  # [nq, p+1]
    WB = (qw[:, None] * B)  # integrates against basis
    n = space.mesh.cells_per_axis
    dim = space.dim
    x1 = quad_grid_1d(space, nq)

    if f is None:
        fvals = np.ones((len(x1),) * dim)
    else:
        coords = np.meshgrid(*([x1] * dim), indexing="ij")
        fvals = np.asarray(f(*coords), dtype=np.float64)

    t = fvals
    for ax in range(dim):
        # quad points don't overlap across cells: clean reshape then contract
        t = np.moveaxis(t, ax, 0)
        shp = t.shape
        t = t.reshape(n, nq, *shp[1:])
        t = np.tensordot(WB, t, axes=(0, 1))  # [p+1, n, ...]
        t = np.moveaxis(t, 0, 1)  # [n, p+1, ...]
        t = np.moveaxis(np.moveaxis(t, 1, -1), 0, ax)
        t = overlap_add_np(t, ax, n, p, p + 1)
    rhs = t * space.mesh.h**dim
    return rhs * space.free_mask()


def _fe_values_at_quad(space: FESpace, u_grid: np.ndarray, nq: int):
    """FE function values at all quadrature points + the weight grid."""
    from .basis import gauss_points, lagrange_eval

    p = space.degree
    qp, qw = gauss_points(nq)
    B = lagrange_eval(space.basis.nodes, qp)  # [nq, p+1]
    n = space.mesh.cells_per_axis
    dim = space.dim

    t = np.asarray(u_grid, dtype=np.float64)
    for ax in range(dim):
        t = split_windows_np(t, ax, n, p, p + 1)  # window axis appended last
        t = np.tensordot(t, B, axes=(-1, 1))  # -> values at quad pts [.., nq]
        t = np.moveaxis(t, -1, ax + 1)
        # merge cell axis (ax) and its quad axis (ax+1)
        shp = t.shape
        t = t.reshape(*shp[:ax], n * nq, *shp[ax + 2 :])
    w1 = np.tile(qw, n)
    wtot = w1
    for _ in range(dim - 1):
        wtot = np.multiply.outer(wtot, w1)
    return t, wtot


def l2_norm(space: FESpace, u_grid: np.ndarray, n_q: int | None = None) -> float:
    """Global L2 norm of the FE function with nodal values u_grid, with
    QGauss(p+2) by default like the reference's integrate_difference
    (reference: source/geometric_multigrid/program.cc:382-395)."""
    nq = n_q if n_q is not None else space.degree + 2
    t, wtot = _fe_values_at_quad(space, u_grid, nq)
    return float(np.sqrt(np.sum(t * t * wtot) * space.mesh.h**space.dim))
