"""Continuous Q_p DoF enumeration on unstructured hex/quad meshes.

The counterpart of the deal.II DoF layer consumed by the reference
(``DoFHandler::distribute_dofs`` + lexicographic renumbering, reference:
source/geometric_multigrid/program.cc:154-158 and
include/operators/portable_laplace_operator.h:494-507): builds the per-cell
``local_to_global`` gather table with correct sharing of vertex / edge /
face DoFs between neighboring cells, including edge-direction and
face-orientation matching.

This module is the pure-Python reference implementation; the C++ twin in
the port's native/ implements the identical algorithm for large meshes
(both must produce bit-identical tables — enforced by tests).  A copy of
``portable_multigrid_tpu/fem/dof_numbering.py``, held equal to it by
tests/test_torch_general_mesh.py.

Local DoFs are lexicographic with axis 0 slowest; cell vertices are
lexicographic corners (axis 0 slowest), matching fem/general_mesh.py.
"""

from __future__ import annotations

import numpy as np

from .general_mesh import GeneralMesh


def _edge_dof(t: int, p: int, flip: bool) -> int:
    """Position of an edge-interior DoF (t in [1, p-1]) after orientation."""
    return p - t if flip else t


def _face_canon(corners: list[int]) -> tuple[tuple[int, ...], int]:
    """Canonicalize a quad face given corners [c00, c01, c10, c11]
    (local (s,t): c_{s t}, t fastest).  Returns (key, sym) where key is the
    canonical corner tuple and sym in [0,8) identifies the D4 symmetry that
    maps local (s,t) to canonical coordinates."""
    c = corners
    # the 8 symmetries: (transpose?, flip_s?, flip_t?) applied to (s, t)
    best = None
    for sym in range(8):
        cs = _face_apply(c, sym)
        if best is None or cs < best[0]:
            best = (cs, sym)
    return best


def _face_apply(c: list[int], sym: int) -> tuple[int, ...]:
    """Corner tuple after symmetry ``sym`` = (transpose, flip_s, flip_t)."""
    transpose = sym & 1
    flip_s = (sym >> 1) & 1
    flip_t = (sym >> 2) & 1
    out = []
    for s in (0, 1):
        for t in (0, 1):
            ss, tt = (t, s) if transpose else (s, t)
            if flip_s:
                ss = 1 - ss
            if flip_t:
                tt = 1 - tt
            out.append(c[ss * 2 + tt])
    return tuple(out)


def _face_coord(sym: int, s: int, t: int, p: int) -> tuple[int, int]:
    """Canonical face coords of a local DoF at (s, t) in [1, p-1]^2.

    ``sym`` is the symmetry T with canonical_corner[(s,t)] =
    local_corner[T(s,t)] (see _face_apply: transpose first, then flips), so
    the local point (s, t) has canonical coordinates T^{-1}(s, t) =
    transpose(flip(s, t))."""
    transpose = sym & 1
    flip_s = (sym >> 1) & 1
    flip_t = (sym >> 2) & 1
    if flip_s:
        s = p - s
    if flip_t:
        t = p - t
    if transpose:
        s, t = t, s
    return s, t


def enumerate_dofs(mesh: GeneralMesh, degree: int):
    """Build the continuous Q_degree numbering.

    Returns (n_dofs, l2g [E, (p+1)^dim] int64, boundary_mask [n_dofs] f64
    with 1.0 on free DoFs and 0.0 on boundary DoFs).
    """
    p = degree
    dim = mesh.dim
    cells = np.asarray(mesh.cells)
    E = cells.shape[0]
    nv = 2**dim
    ndof = (p + 1) ** dim

    vertex_dof: dict[int, int] = {}
    edge_base: dict[tuple[int, int], int] = {}
    face_base: dict[tuple[int, ...], tuple[int, int]] = {}  # key -> (base, sym0)
    next_dof = 0

    l2g = np.zeros((E, ndof), dtype=np.int64)

    # --- face bookkeeping for boundary detection -------------------------
    face_count: dict[tuple[int, ...], int] = {}
    face_corners_of_cell = []  # per cell: list of (axis, side, corners)

    def local_vertex(ii):
        """vertex index (0..2^dim) from boundary coords (each 0 or p)."""
        out = 0
        for k in range(dim):
            out = out * 2 + (1 if ii[k] == p else 0)
        return out

    for e in range(E):
        cv = cells[e]
        # precompute this cell's faces (3D) for boundary detection
        if dim == 3:
            faces = []
            for axis in range(3):
                for side in (0, 1):
                    corners = []
                    for a in (0, 1):
                        for b in (0, 1):
                            ii = [0] * 3
                            ii[axis] = side
                            rest = [k for k in range(3) if k != axis]
                            ii[rest[0]] = a
                            ii[rest[1]] = b
                            corners.append(
                                int(cv[ii[0] * 4 + ii[1] * 2 + ii[2]])
                            )
                    key = tuple(sorted(corners))
                    face_count[key] = face_count.get(key, 0) + 1
                    faces.append((axis, side, corners, key))
            face_corners_of_cell.append(faces)
        elif dim == 2:
            faces = []
            for axis in range(2):
                for side in (0, 1):
                    ends = []
                    for a in (0, 1):
                        ii = [0] * 2
                        ii[axis] = side
                        ii[1 - axis] = a
                        ends.append(int(cv[ii[0] * 2 + ii[1]]))
                    key = tuple(sorted(ends))
                    face_count[key] = face_count.get(key, 0) + 1
                    faces.append((axis, side, ends, key))
            face_corners_of_cell.append(faces)
        else:
            faces = []
            for side, v in ((0, int(cv[0])), (1, int(cv[1]))):
                key = (v,)
                face_count[key] = face_count.get(key, 0) + 1
                faces.append((0, side, [v], key))
            face_corners_of_cell.append(faces)

    for e in range(E):
        cv = cells[e]
        for loc in range(ndof):
            # local coords, axis 0 slowest
            rem = loc
            ii = []
            for k in range(dim):
                ii.append(rem // (p + 1) ** (dim - 1 - k))
                rem %= (p + 1) ** (dim - 1 - k)
            onb = [0 if ii[k] == 0 else (1 if ii[k] == p else -1) for k in range(dim)]
            n_interior = sum(1 for k in range(dim) if onb[k] == -1)

            if n_interior == 0:
                # vertex DoF
                v = int(cv[local_vertex(ii)])
                if v not in vertex_dof:
                    vertex_dof[v] = next_dof
                    next_dof += 1
                l2g[e, loc] = vertex_dof[v]
            elif n_interior == 1 and dim > 1:
                # edge DoF: free axis k, others pinned
                k = next(a for a in range(dim) if onb[a] == -1)
                iia = list(ii)
                iia[k] = 0
                iib = list(ii)
                iib[k] = p
                va = int(cv[local_vertex(iia)])
                vb = int(cv[local_vertex(iib)])
                key = (min(va, vb), max(va, vb))
                if key not in edge_base:
                    edge_base[key] = next_dof
                    next_dof += p - 1
                t = _edge_dof(ii[k], p, flip=va > vb)
                l2g[e, loc] = edge_base[key] + (t - 1)
            elif n_interior == 2 and dim == 3:
                # face DoF: pinned axis k
                k = next(a for a in range(dim) if onb[a] != -1)
                free = [a for a in range(dim) if a != k]
                corners = []
                for a in (0, p):
                    for b in (0, p):
                        jj = list(ii)
                        jj[free[0]] = a
                        jj[free[1]] = b
                        corners.append(int(cv[local_vertex(jj)]))
                key, sym = _face_canon(corners)
                if key not in face_base:
                    face_base[key] = next_dof
                    next_dof += (p - 1) ** 2
                s, t = _face_coord(sym, ii[free[0]], ii[free[1]], p)
                l2g[e, loc] = face_base[key] + (s - 1) * (p - 1) + (t - 1)
            else:
                # cell-interior DoF
                pass
        # cell interiors: contiguous block per cell
        for loc in range(ndof):
            rem = loc
            ii = []
            for k in range(dim):
                ii.append(rem // (p + 1) ** (dim - 1 - k))
                rem %= (p + 1) ** (dim - 1 - k)
            if all(0 < ii[k] < p for k in range(dim)):
                # order by lexicographic interior index
                idx = 0
                for k in range(dim):
                    idx = idx * (p - 1) + (ii[k] - 1)
                if not hasattr(enumerate_dofs, "_marker"):
                    pass
                l2g[e, loc] = next_dof + idx
        if p > 1:
            next_dof += (p - 1) ** dim

    n_dofs = next_dof

    # --- boundary mask -----------------------------------------------------
    boundary = np.zeros(n_dofs, dtype=bool)
    for e in range(E):
        for axis, side, _, key in face_corners_of_cell[e]:
            if face_count[key] != 1:
                continue
            # all local DoFs on this face are boundary DoFs
            for loc in range(ndof):
                rem = loc
                ii = []
                for k in range(dim):
                    ii.append(rem // (p + 1) ** (dim - 1 - k))
                    rem %= (p + 1) ** (dim - 1 - k)
                if ii[axis] == (0 if side == 0 else p):
                    boundary[l2g[e, loc]] = True
    mask = np.where(boundary, 0.0, 1.0)
    return n_dofs, l2g, mask
