"""General (unstructured) hex/quad meshes with Q1 isoparametric mapping.

The structured fast path (fem/mesh.py) covers the reference's benchmark
configurations; this module provides the general-mesh capability of the
deal.II layer the reference builds on (``Triangulation`` + ``MappingQ``,
reference: include/operators/portable_laplace_operator.h:469-482 consumes
mapping-dependent ``inv_jacobian``/``JxW`` tables through
Portable::MatrixFree): arbitrary vertex positions, per-cell Jacobians and
quadrature weights evaluated at all quadrature points.

A mesh is (vertices [V, dim], cells [E, 2^dim]) with cell vertex ordering
lexicographic in the reference cell (z slowest ... consistent with the rest
of the package: axis 0 slowest).  The mapping is (multi-)linear Q1; the
reference uses MappingQ(p) which coincides with Q1 on affine meshes (all its
drivers) — curved higher-order mappings are :class:`CurvedGeometry`.

A NumPy copy of ``portable_multigrid_tpu/fem/general_mesh.py`` (that
package imports JAX eagerly, and the port never imports JAX); held equal to
it array by array by tests/test_torch_general_mesh.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .basis import gauss_points


def _q1_shape_1d(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Linear shape functions and derivatives at points x in [0,1]."""
    vals = np.stack([1.0 - x, x], axis=-1)  # [nx, 2]
    grads = np.broadcast_to(np.array([-1.0, 1.0]), vals.shape).copy()
    return vals, grads


@dataclasses.dataclass(frozen=True)
class GeneralMesh:
    """Unstructured hex (3D) / quad (2D) / line (1D) mesh."""

    vertices: np.ndarray  # [V, dim]
    cells: np.ndarray  # [E, 2^dim] vertex ids, lexicographic (axis 0 slowest)

    @property
    def dim(self) -> int:
        return self.vertices.shape[1]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    def cell_vertices(self) -> np.ndarray:
        """[E, 2^dim, dim] vertex coordinates per cell."""
        return self.vertices[self.cells]

    def geometry_tables(self, n_q_1d: int) -> tuple[np.ndarray, np.ndarray]:
        """Per-cell inverse Jacobians and JxW at tensor quadrature points.

        Returns (inv_jac [E, Q, dim, dim], jxw [E, Q]) with Q = n_q_1d^dim —
        the device-resident equivalents of ``precomputed_data.inv_jacobian`` and
        ``JxW`` (reference: include/operators/portable_laplace_operator.h:
        300-325).  inv_jac[e, q, d1, d2] = (dxi_d1 / dx_d2), so the physical
        gradient is inv_jac^T @ reference gradient.
        """
        dim = self.dim
        qp, qw = gauss_points(n_q_1d)
        vals, grads = _q1_shape_1d(qp)  # [nq, 2] each

        # tensor Q1 shape values/gradients at all quadrature points:
        # N[v, q] and dN[k][v, q] with lexicographic v (axis 0 slowest)
        nq = n_q_1d
        Q = nq**dim
        nv = 2**dim
        N = np.ones((nv, Q))
        dN = np.ones((dim, nv, Q))
        for axis in range(dim):
            # vertex bit for this axis (axis 0 slowest)
            vbits = (np.arange(nv) >> (dim - 1 - axis)) & 1  # [nv]
            # quadrature index along this axis (axis 0 slowest)
            qidx = (np.arange(Q) // (nq ** (dim - 1 - axis))) % nq
            N *= vals[qidx][:, vbits].T
            for k in range(dim):
                dN[k] *= (grads if k == axis else vals)[qidx][:, vbits].T

        xv = self.cell_vertices()  # [E, nv, dim]
        # J[e, q, d_phys, d_ref] = sum_v x[e, v, d_phys] dN[d_ref, v, q]
        J = np.einsum("evd,kvq->eqdk", xv, dN)
        detJ = np.linalg.det(J)
        if np.any(detJ <= 0):
            raise ValueError("mesh contains inverted or degenerate cells")
        Jinv = np.linalg.inv(J)  # [E, Q, d_ref, d_phys] = dxi/dx
        wq = np.array([1.0])
        for _ in range(dim):
            wq = np.kron(wq, qw)
        jxw = detJ * wq[None, :]
        return Jinv, jxw

    def physical_quad_points(self, n_q_1d: int) -> np.ndarray:
        """Physical coordinates of all tensor quadrature points [E, Q, dim]."""
        qp, _ = gauss_points(n_q_1d)
        N, _ = _tensor_shape_tables(np.array([0.0, 1.0]), qp, self.dim)
        return np.einsum("evd,vq->eqd", self.cell_vertices(), N)


def _tensor_shape_tables(nodes: np.ndarray, qp: np.ndarray, dim: int):
    """Tensor Lagrange shape values/gradients at tensor quadrature points.

    Returns (N [nn, Q], dN [dim, nn, Q]) with lexicographic node ordering
    (axis 0 slowest), nn = len(nodes)^dim, Q = len(qp)^dim."""
    from .basis import lagrange_deriv, lagrange_eval

    V = lagrange_eval(nodes, qp)  # [nq, m]
    D = lagrange_deriv(nodes, qp)
    m = len(nodes)
    nq = len(qp)
    nn, Q = m**dim, nq**dim
    N = np.ones((nn, Q))
    dN = np.ones((dim, nn, Q))
    for axis in range(dim):
        vdig = (np.arange(nn) // (m ** (dim - 1 - axis))) % m
        qidx = (np.arange(Q) // (nq ** (dim - 1 - axis))) % nq
        N *= V[qidx][:, vdig].T
        for k in range(dim):
            dN[k] *= (D if k == axis else V)[qidx][:, vdig].T
    return N, dN


@dataclasses.dataclass(frozen=True)
class CurvedGeometry:
    """Higher-order (Q_q Lagrange) cell geometry — the MappingQ(q) analog.

    The reference constructs MappingQ(fe_degree) (reference:
    include/operators/portable_laplace_operator.h:469-482); on its affine
    benchmark meshes this coincides with Q1, but the data model supports
    genuinely curved cells.  Here each cell carries (q+1)^dim mapping control
    points (values of the geometry at tensor Gauss-Lobatto nodes), and
    Jacobian/JxW tables are evaluated from the Q_q interpolant — exactly
    isoparametric when q == fe_degree.
    """

    cell_points: np.ndarray  # [E, (q+1)^dim, dim], lexicographic nodes
    mapping_degree: int

    @property
    def dim(self) -> int:
        return self.cell_points.shape[2]

    @property
    def n_cells(self) -> int:
        return self.cell_points.shape[0]

    def _nodes(self) -> np.ndarray:
        from .basis import gauss_lobatto_points

        return gauss_lobatto_points(self.mapping_degree + 1)

    def geometry_tables(self, n_q_1d: int) -> tuple[np.ndarray, np.ndarray]:
        """(inv_jac [E, Q, dim, dim], jxw [E, Q]) — same contract as
        :meth:`GeneralMesh.geometry_tables`, for the Q_q mapping."""
        dim = self.dim
        qp, qw = gauss_points(n_q_1d)
        _, dN = _tensor_shape_tables(self._nodes(), qp, dim)
        J = np.einsum("evd,kvq->eqdk", self.cell_points, dN)
        detJ = np.linalg.det(J)
        if np.any(detJ <= 0):
            raise ValueError("mapping contains inverted or degenerate cells")
        Jinv = np.linalg.inv(J)
        wq = np.array([1.0])
        for _ in range(dim):
            wq = np.kron(wq, qw)
        return Jinv, detJ * wq[None, :]

    def physical_quad_points(self, n_q_1d: int) -> np.ndarray:
        """Physical coordinates of all tensor quadrature points [E, Q, dim]."""
        qp, _ = gauss_points(n_q_1d)
        N, _ = _tensor_shape_tables(self._nodes(), qp, self.dim)
        return np.einsum("evd,vq->eqd", self.cell_points, N)


def curved_structured_geometry(
    dim: int, n: int, transform, mapping_degree: int
) -> CurvedGeometry:
    """CurvedGeometry for Φ([0,1]^dim) on an n^dim structured cell lattice.

    ``transform(*ref_coords) -> phys_coords`` is the smooth geometry (the
    manifold description MappingQ would pull node locations from); control
    points are its values at each cell's tensor Gauss-Lobatto nodes."""
    from .basis import gauss_lobatto_points

    q = mapping_degree
    nodes = gauss_lobatto_points(q + 1)
    nn = (q + 1) ** dim
    E = n**dim
    pts = np.zeros((E, nn, dim))
    for e in range(E):
        cidx = np.unravel_index(e, (n,) * dim)
        axes = [(cidx[k] + nodes) / n for k in range(dim)]
        grids = np.meshgrid(*axes, indexing="ij")
        ref = [g.reshape(-1) for g in grids]
        out = transform(*ref)
        pts[e] = np.stack([np.asarray(o, np.float64) for o in out], axis=-1)
    return CurvedGeometry(cell_points=pts, mapping_degree=q)


def structured_as_general(mesh) -> GeneralMesh:
    """Convert a HyperCubeMesh to a GeneralMesh (for cross-validation)."""
    n = mesh.cells_per_axis
    dim = mesh.dim
    x1 = np.linspace(mesh.a, mesh.b, n + 1)
    grids = np.meshgrid(*([x1] * dim), indexing="ij")
    vertices = np.stack([g.reshape(-1) for g in grids], axis=-1)
    V = n + 1

    def vid(idx):
        out = 0
        for k in range(dim):
            out = out * V + idx[k]
        return out

    cells = []
    for e in range(n**dim):
        cidx = np.unravel_index(e, (n,) * dim)
        verts = []
        for v in range(2**dim):
            idx = [cidx[k] + ((v >> (dim - 1 - k)) & 1) for k in range(dim)]
            verts.append(vid(idx))
        cells.append(verts)
    return GeneralMesh(vertices=vertices, cells=np.asarray(cells))


def refine_general_mesh(gm: GeneralMesh) -> GeneralMesh:
    """Uniform isotropic refinement: every cell splits into 2^dim children.

    Children are ordered parent-major with the child index lexicographic in
    the parent's reference axes (axis 0 slowest) — the ordering the
    unstructured transfer (ops/indexed.py:IndexedTransfer) relies on.  New
    vertices are Q1 (multilinear) sub-entity midpoints, deduplicated
    TOPOLOGICALLY by the set of parent corner ids they average — midpoint
    refinement of a multilinear map restricted to a sub-box is again
    multilinear, so the refined geometry is exactly nested and the standard
    h-embedding matrices apply (the unstructured analog of the reference's
    create_geometric_coarsening_sequence,
    source/geometric_multigrid/program.cc:137-147).
    """
    dim = gm.dim
    nv = 2**dim
    points: list[np.ndarray] = []
    key2id: dict[tuple, int] = {}

    def pid(key, coord):
        if key not in key2id:
            key2id[key] = len(points)
            points.append(coord)
        return key2id[key]

    new_cells = []
    for e in range(gm.n_cells):
        corners = gm.cells[e]
        xv = gm.vertices[corners]  # [nv, dim]

        def lattice(g):
            """Refined-lattice point at local coords g in {0,1,2}^dim."""
            ids = []
            coord = np.zeros(dim)
            for v in range(nv):
                w = 1.0
                for k in range(dim):
                    bit = (v >> (dim - 1 - k)) & 1
                    gk = g[k]
                    wk = (
                        0.5 if gk == 1 else (1.0 if (gk == 2) == bool(bit)
                                             else 0.0)
                    )
                    w *= wk
                if w > 0:
                    ids.append(int(corners[v]))
                    coord = coord + w * xv[v]
            return pid(tuple(sorted(ids)), coord)

        for c in range(nv):
            cbits = [(c >> (dim - 1 - k)) & 1 for k in range(dim)]
            verts = []
            for v in range(nv):
                vbits = [(v >> (dim - 1 - k)) & 1 for k in range(dim)]
                verts.append(
                    lattice(tuple(cbits[k] + vbits[k] for k in range(dim)))
                )
            new_cells.append(verts)
    return GeneralMesh(
        vertices=np.asarray(points), cells=np.asarray(new_cells)
    )


def perturbed_cube_mesh(
    dim: int, n: int, amplitude: float = 0.15, seed: int = 0
) -> GeneralMesh:
    """A smoothly distorted unit-cube mesh (interior vertices perturbed) —
    exercises genuinely non-affine geometry in tests."""
    x1 = np.linspace(0.0, 1.0, n + 1)
    grids = np.meshgrid(*([x1] * dim), indexing="ij")
    vertices = np.stack([gg.reshape(-1) for gg in grids], axis=-1)
    rng = np.random.default_rng(seed)
    h = 1.0 / n
    interior = np.all((vertices > 1e-12) & (vertices < 1 - 1e-12), axis=1)
    vertices = vertices + np.where(
        interior[:, None],
        rng.uniform(-amplitude * h, amplitude * h, vertices.shape),
        0.0,
    )
    V = n + 1
    cells = []
    for e in range(n**dim):
        cidx = np.unravel_index(e, (n,) * dim)
        verts = []
        for v in range(2**dim):
            idx = [cidx[k] + ((v >> (dim - 1 - k)) & 1) for k in range(dim)]
            out = 0
            for k in range(dim):
                out = out * V + idx[k]
            verts.append(out)
        cells.append(verts)
    return GeneralMesh(vertices=vertices, cells=np.asarray(cells))
