"""Indexed (general-geometry) matrix-free Laplace operator and transfer
(plain torch).

Counterpart of ``portable_multigrid_tpu/ops/indexed.py``: per-cell gather
through an explicit ``local_to_global`` table and per-cell,
per-quadrature-point geometry (``inv_jacobian``, ``JxW``), the data model
of the reference's ``Portable::MatrixFree`` backbone (reference:
include/operators/portable_laplace_operator.h:251-257 [l2g gather],
:300-325 [per-q-point metric], :361-380 [scatter]).  The JAX package has no
Pallas kernel on this path; its gather/scatter is XLA's, and here it is
torch's.

The scatter is deterministic, as XLA's scatter-add is: CUDA's
``index_add_`` sums with atomics, whose order changes from run to run.  So
each scatter target's entries are listed once at setup in a padded table
[k_max, n] of positions into the flat element array (:func:`scatter_table`;
pad entries point at one zero slot past its end), and the sum is a gather
and a reduction over the table's first axis (:func:`scatter_sum`): the same
input gives bitwise the same output, with no host sync, so a CUDA graph
captures it.  Indices are int64 on every device.

The cell-local work is two GEMMs over all cells with the dense element
gradient matrix ``Gmat`` [(p+1)^dim, dim * Q] (``ops/laplace.py``
``grad_matrix``, the kron of the 1D factors that the JAX package applies
one axis at a time): nodal values to reference gradients at every
quadrature point, and back.  Between them each point's gradient is
multiplied by its dim x dim metric.  The per-axis contractions of the JAX
package's apply (matrices of p + 1 along one axis of small cell arrays)
are GEMMs with two dimensions of p + 1, which the card runs at a few
percent of its rate.

Use this path for distorted, mapped and fully unstructured meshes; the
structured variants in ops/laplace.py are the fast path for Cartesian
grids.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fem.assemble import gradient_matrices
from ..fem.general_mesh import GeneralMesh
from ..fem.space import FESpace
from .laplace import grad_matrix
from .structured import matmul


def scatter_table(l2g: np.ndarray, n: int) -> np.ndarray:
    """[k_max, n] int64: row k holds, for each target j < n, the position
    in ``l2g.reshape(-1)`` of the k-th entry that names j (in the order of
    the flat array), or ``l2g.size`` (the zero slot) where j has fewer than
    k + 1 entries; k_max is the largest count of any target."""
    flat = np.asarray(l2g, np.int64).reshape(-1)
    m = flat.size
    order = np.argsort(flat, kind="stable")
    counts = np.bincount(flat, minlength=n)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ids = flat[order]
    rank = np.arange(m) - starts[ids]
    table = np.full((int(counts.max(initial=1)), n), m, np.int64)
    table[rank, ids] = order
    return table


def scatter_sum(values: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """out[j] = sum over k of values.flat[table[k, j]]: the scatter-add of
    ``values`` through the table's l2g, in a fixed order."""
    flat = values.reshape(-1)
    ext = torch.cat([flat, flat.new_zeros(1)])
    return ext[table].sum(0)


@dataclasses.dataclass
class IndexedLaplaceOperator:
    """Matrix-free Laplace with explicit gather/scatter + general geometry."""

    dim: int
    degree: int
    n_dofs: int
    l2g: torch.Tensor  # [E, (p+1)^dim] int64
    metric: torch.Tensor  # [E, dim, dim, Q]: JxW * Jinv Jinv^T
    Gmat: torch.Tensor  # [(p+1)^dim, dim * Q] reference gradients
    mask: torch.Tensor  # [n_dofs] flat free mask
    inv_diag: torch.Tensor  # [n_dofs] flat
    scatter: torch.Tensor  # [k_max, n_dofs] int64 (scatter_table of l2g)

    @property
    def shape(self) -> tuple:
        return (self.n_dofs,)

    @property
    def dtype(self) -> torch.dtype:
        return self.metric.dtype

    @property
    def device(self) -> torch.device:
        return self.metric.device

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        u = u.reshape(self.n_dofs)
        ue = (u * self.mask)[self.l2g]  # [E, (p+1)^dim]
        E, dim = ue.shape[0], self.dim
        G = matmul(ue, self.Gmat).reshape(E, dim, -1)  # [E, dim, Q]
        # W_r = sum_s metric_rs G_s at every quadrature point
        W = self.metric[:, :, 0] * G[:, None, 0]
        for s in range(1, dim):
            W = torch.addcmul(W, self.metric[:, :, s], G[:, None, s])
        r = matmul(W.reshape(E, -1), self.Gmat.T)  # [E, (p+1)^dim]
        au = scatter_sum(r, self.scatter)
        return self.mask * au + (1.0 - self.mask) * u

    vmult = apply


def indexed_operator(dim: int, degree: int, n_dofs: int, l2g, metric, B,
                     Dco, mask, inv_diag, dtype=torch.float64,
                     device="cpu") -> IndexedLaplaceOperator:
    """The operator from host arrays (int l2g; the metric [E, Q, dim, dim],
    the 1D ``B`` and ``Dco``, float64), with its element gradient matrix and
    scatter table."""

    def t(a):
        return torch.as_tensor(np.array(a, np.float64), dtype=dtype,
                               device=device)

    l2g = np.array(l2g, np.int64)
    return IndexedLaplaceOperator(
        dim=int(dim), degree=int(degree), n_dofs=int(n_dofs),
        l2g=torch.as_tensor(l2g, device=device),
        metric=t(np.ascontiguousarray(np.moveaxis(np.asarray(metric), 1,
                                                  3))),
        Gmat=t(grad_matrix(np.asarray(B), np.asarray(Dco), int(dim))),
        mask=t(mask), inv_diag=t(inv_diag),
        scatter=torch.as_tensor(scatter_table(l2g, int(n_dofs)),
                                device=device))


def _metric_tables(gmesh: GeneralMesh, degree: int) -> np.ndarray:
    inv_jac, jxw = gmesh.geometry_tables(degree + 1)
    # metric[r, s] = JxW * sum_d Jinv[r, d] Jinv[s, d]
    return np.einsum("eqrd,eqsd,eq->eqrs", inv_jac, inv_jac, jxw)


def _indexed_diagonal(
    metric: np.ndarray, l2g: np.ndarray, degree: int, dim: int, n_dofs: int
) -> np.ndarray:
    """The operator's diagonal: sum_q metric_rs G_r G_s per cell (one GEMM
    per (r, s)), summed over the cells that share each DoF."""
    G = gradient_matrices(degree, dim)  # G_r[Q, ndof] reference gradients
    E = metric.shape[0]
    d_loc = np.zeros((E, G[0].shape[1]))
    for r in range(dim):
        for s in range(dim):
            d_loc += metric[:, :, r, s] @ (G[r] * G[s])
    return np.bincount(np.asarray(l2g).reshape(-1),
                       weights=d_loc.reshape(-1), minlength=n_dofs)


def make_indexed_laplace(
    space: FESpace,
    gmesh: GeneralMesh | None = None,
    dtype=torch.float64,
    device="cpu",
) -> IndexedLaplaceOperator:
    """Build the indexed operator.

    ``space`` provides the DoF topology and constraints; ``gmesh`` provides
    the geometry (a :class:`GeneralMesh` or a ``CurvedGeometry``; defaults
    to the space's own Cartesian mesh, in which case the operator equals
    the structured variants — used for cross-validation).
    """
    from ..fem.general_mesh import structured_as_general

    if gmesh is None:
        gmesh = structured_as_general(space.mesh)
    if gmesh.n_cells != space.mesh.n_cells:
        raise ValueError("geometry mesh does not match the DoF space")
    b = space.basis
    l2g = space.local_to_global()
    metric = _metric_tables(gmesh, space.degree)
    mask = space.free_mask().reshape(-1)
    diag = _indexed_diagonal(
        metric, l2g, space.degree, space.dim, space.n_dofs
    )
    diag = diag * mask + (1.0 - mask)
    return indexed_operator(space.dim, space.degree, space.n_dofs, l2g,
                            metric, b.B, b.Dco, mask, 1.0 / diag, dtype,
                            device)


def make_unstructured_laplace(
    gmesh: GeneralMesh, degree: int, dtype=torch.float64, dofs=None,
    device="cpu",
) -> IndexedLaplaceOperator:
    """Fully unstructured path: DoF topology from the native enumerator
    (edge/face orientation matching), geometry from the Q1 mapping.

    Homogeneous Dirichlet on the whole mesh boundary (faces shared by a
    single cell), matching the reference drivers' boundary_id 0.
    ``dofs`` optionally passes a precomputed (n_dofs, l2g, mask) pack.
    """
    from ..fem.basis import make_basis
    from ..native import enumerate_dofs

    n_dofs, l2g, mask = dofs if dofs is not None else enumerate_dofs(
        gmesh, degree
    )
    b = make_basis(degree)
    metric = _metric_tables(gmesh, degree)
    diag = _indexed_diagonal(metric, l2g, degree, gmesh.dim, n_dofs)
    diag = diag * mask + (1.0 - mask)
    return indexed_operator(gmesh.dim, degree, n_dofs, l2g, metric, b.B,
                            b.Dco, mask, 1.0 / diag, dtype, device)


@dataclasses.dataclass
class IndexedTransfer:
    """Two-level h-transfer on unstructured meshes via per-cell embeddings.

    The unstructured analog of ops/transfer.py:Transfer, mirroring the
    reference's GeometricTransfer data model (per-cell coarse/fine DoF index
    tables + the 1D embedding matrix + 1/valence weights; reference:
    include/multigrid/portable_geometric_transfer.h:33-86,1329-1487) —
    except the per-child tensor embedding is applied as one GEMM over the
    cells and the scatter is :func:`scatter_sum`.

    prolongate:  gather coarse cell DoFs (masked) -> per-child embedding
                 matmul -> scatter-add to fine -> 1/valence * fine-mask.
    restrict:    the exact transpose (weights first).
    """

    n_c: int
    n_f: int
    l2g_c: torch.Tensor  # [Ec, ndof] int64
    l2g_f: torch.Tensor  # [Ec, 2^dim, ndof] int64 (children by parent)
    Mch: torch.Tensor  # [2^dim, ndof_f, ndof_c] child embeddings
    w_f: torch.Tensor  # [n_f] 1/valence * fine mask
    mask_c: torch.Tensor  # [n_c]
    scatter_c: torch.Tensor  # scatter_table of l2g_c
    scatter_f: torch.Tensor  # scatter_table of l2g_f

    def prolongate(self, c: torch.Tensor) -> torch.Tensor:
        c = c.reshape(self.n_c) * self.mask_c
        cc = c[self.l2g_c]  # [Ec, ndof]
        K, F, L = self.Mch.shape
        fe = matmul(cc, self.Mch.reshape(K * F, L).T)  # [Ec, K * F]
        return scatter_sum(fe, self.scatter_f) * self.w_f

    def prolongate_and_add(self, dst, c):
        return dst + self.prolongate(c)

    def restrict(self, f: torch.Tensor) -> torch.Tensor:
        fw = f.reshape(self.n_f) * self.w_f
        K, F, L = self.Mch.shape
        fe = fw[self.l2g_f].reshape(-1, K * F)  # [Ec, K * F]
        ce = matmul(fe, self.Mch.reshape(K * F, L))  # [Ec, ndof]
        return scatter_sum(ce, self.scatter_c) * self.mask_c

    def restrict_and_add(self, dst, f):
        return dst + self.restrict(f)


def indexed_transfer(n_c: int, n_f: int, l2g_c, l2g_f, Mch, w_f, mask_c,
                     dtype=torch.float64, device="cpu") -> IndexedTransfer:
    """The transfer from host arrays (``l2g_f`` [Ec, 2^dim, ndof]), with
    its scatter tables."""

    def t(a):
        return torch.as_tensor(np.array(a, np.float64), dtype=dtype,
                               device=device)

    l2g_c = np.array(l2g_c, np.int64)
    l2g_f = np.array(l2g_f, np.int64)
    return IndexedTransfer(
        n_c=int(n_c), n_f=int(n_f),
        l2g_c=torch.as_tensor(l2g_c, device=device),
        l2g_f=torch.as_tensor(l2g_f, device=device),
        Mch=t(Mch), w_f=t(w_f), mask_c=t(mask_c),
        scatter_c=torch.as_tensor(scatter_table(l2g_c, int(n_c)),
                                  device=device),
        scatter_f=torch.as_tensor(scatter_table(l2g_f, int(n_f)),
                                  device=device))


def make_unstructured_h_transfer(
    gmesh_c: GeneralMesh,
    degree: int,
    coarse_dofs: tuple,
    fine_dofs: tuple,
    dtype=torch.float64,
    device="cpu",
) -> IndexedTransfer:
    """Transfer between an unstructured mesh and its refine_general_mesh
    child (children parent-major, child index lexicographic).

    ``coarse_dofs``/``fine_dofs`` are (n_dofs, l2g, mask) as returned by the
    native enumerator for the two levels."""
    from ..fem.basis import h_prolongation_matrix_1d

    dim = gmesh_c.dim
    p = degree
    n_c, l2g_c, mask_c = coarse_dofs
    n_f, l2g_f, mask_f = fine_dofs
    Ec = gmesh_c.n_cells
    if l2g_f.shape[0] != Ec * 2**dim:
        raise ValueError("fine mesh is not the refinement of the coarse mesh")

    M1 = h_prolongation_matrix_1d(p)  # [2p+1, p+1]
    halves = (M1[: p + 1], M1[p:])  # child 0 / child 1 along one axis
    Mch = []
    for c in range(2**dim):
        M = np.array([[1.0]])
        for k in range(dim):
            M = np.kron(M, halves[(c >> (dim - 1 - k)) & 1])
        Mch.append(M)
    Mch = np.stack(Mch)  # [2^dim, ndof, ndof]

    # each fine DoF appears once per fine cell containing it == its valence
    counts = np.bincount(np.asarray(l2g_f).reshape(-1), minlength=n_f)
    w = mask_f / np.maximum(counts, 1.0)
    return indexed_transfer(n_c, n_f, l2g_c, l2g_f.reshape(Ec, 2**dim, -1),
                            Mch, w, mask_c, dtype, device)


def dense_unstructured_operator(gmesh: GeneralMesh, degree: int) -> np.ndarray:
    """Dense golden operator on a fully unstructured mesh (tiny meshes)."""
    from ..native import enumerate_dofs

    n_dofs, l2g, mask = enumerate_dofs(gmesh, degree)
    metric = _metric_tables(gmesh, degree)
    G = gradient_matrices(degree, gmesh.dim)
    A = np.zeros((n_dofs, n_dofs))
    for e in range(l2g.shape[0]):
        A_loc = np.zeros((l2g.shape[1], l2g.shape[1]))
        for r in range(gmesh.dim):
            for s in range(gmesh.dim):
                A_loc += np.einsum(
                    "q,ql,qm->lm", metric[e, :, r, s], G[r], G[s]
                )
        idx = l2g[e]
        A[np.ix_(idx, idx)] += A_loc
    A = A * mask[:, None] * mask[None, :]
    A[np.arange(n_dofs), np.arange(n_dofs)] += 1.0 - mask
    return A


def dense_indexed_operator(space: FESpace, gmesh) -> np.ndarray:
    """Dense golden operator for general geometry (tiny meshes)."""
    metric = _metric_tables(gmesh, space.degree)
    G = gradient_matrices(space.degree, space.dim)
    l2g = space.local_to_global()
    N = space.n_dofs
    A = np.zeros((N, N))
    for e in range(l2g.shape[0]):
        A_loc = np.zeros((l2g.shape[1], l2g.shape[1]))
        for r in range(space.dim):
            for s in range(space.dim):
                A_loc += np.einsum(
                    "q,ql,qm->lm", metric[e, :, r, s], G[r], G[s]
                )
        idx = l2g[e]
        A[np.ix_(idx, idx)] += A_loc
    m = space.free_mask().reshape(-1)
    A = A * m[:, None] * m[None, :]
    A[np.arange(N), np.arange(N)] += 1.0 - m
    return A
