"""Geometric multigrid on general (non-affine) geometry (torch port).

Counterpart of ``portable_multigrid_tpu/models/general_geometry.py``
(``FlatTransfer``, ``coarsen_vertex_grid``, ``UnstructuredMultigrid``,
``GeneralGeometryMultigrid``, ``CurvedMultigrid``).  The reference supports
arbitrary deal.II meshes through MappingQ-dependent geometry tables even
though its drivers only run cubes; these models provide the same capability
end to end: indexed operators with per-quadrature-point Jacobians
(``ops/indexed.py``) on a hierarchy of nested-topology meshes, with
rediscretized coarse operators, Chebyshev(5) smoothing, V(2,2) and CG.

Grid-transfer operators act on REFERENCE-cell DoFs and are
geometry-independent (deal.II's global-coarsening transfers likewise), so
on a deformed or curved mesh of structured topology the structured
h-transfer applies unchanged (wrapped by :class:`FlatTransfer` for the
indexed path's flat vectors); only the operators carry the geometry.  On a
fully unstructured mesh the transfer is ``ops/indexed.py:IndexedTransfer``.

Every level is plain torch: the JAX package has no Pallas kernel on this
path.  On a CUDA device a solve replays the V-cycle from a CUDA graph
(``solvers/vcycle.py`` ``GraphedVCycle``), the counterpart of the JAX
package's jitted CG; with ``graph=False``, and on the CPU, it runs eagerly.
Each model keeps the host seconds of its setup by step in
``setup_seconds``.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ..fem.general_mesh import GeneralMesh
from ..fem.mesh import HyperCubeMesh
from ..fem.space import FESpace
from ..ops.indexed import make_indexed_laplace
from ..ops.transfer import make_h_transfer
from ..solvers.cg import cg
from ..solvers.chebyshev import make_chebyshev
from ..solvers.vcycle import MGLevel
from .poisson import SolveStats, _MultigridBase


@dataclasses.dataclass
class FlatTransfer:
    """Grid transfer adapted to flat (indexed-path) vectors."""

    coarse_shape: tuple
    fine_shape: tuple
    inner: object = None

    def prolongate(self, c):
        return self.inner.prolongate(c.reshape(self.coarse_shape)).reshape(-1)

    def prolongate_and_add(self, dst, c):
        return dst + self.prolongate(c)

    def restrict(self, f):
        return self.inner.restrict(f.reshape(self.fine_shape)).reshape(-1)

    def restrict_and_add(self, dst, f):
        return dst + self.restrict(f)


def coarsen_vertex_grid(gmesh: GeneralMesh, dim: int, n_fine: int) -> GeneralMesh:
    """Subsample a structured-topology vertex grid by 2 in every direction."""
    from ..fem.general_mesh import structured_as_general

    V = n_fine + 1
    verts = gmesh.vertices.reshape((V,) * dim + (dim,))
    sl = (slice(None, None, 2),) * dim
    coarse_verts = verts[sl].reshape(-1, dim)
    n_c = n_fine // 2
    topo = structured_as_general(HyperCubeMesh(dim, int(math.log2(n_c))))
    return GeneralMesh(vertices=coarse_verts, cells=topo.cells)


def _host(u) -> np.ndarray:
    """A solution as a float64 NumPy vector, wherever it lies."""
    if isinstance(u, torch.Tensor):
        u = u.detach().cpu().numpy()
    return np.asarray(u, np.float64).reshape(-1)


class _IndexedMultigrid:
    """Common machinery: levels of indexed operators with Chebyshev
    smoothers (Chebyshev-as-solver on the coarsest), the V-cycle, the CG
    solve, and the setup's host seconds by step."""

    # the V-cycle, graphed on a CUDA device, as the structured models build
    # it: every level here runs on full flat vectors in one dtype
    fine_trimmed = False
    io_dtype = None
    fine_operator = _MultigridBase.fine_operator
    preconditioner = _MultigridBase.preconditioner

    def __init__(self, dtype, device):
        self.dtype = dtype
        self.device = torch.device(device)
        self._graphed = {}  # GraphedVCycle by (pre, post) smoothing steps
        self.setup_seconds = {}

    def _timed(self, step: str, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        self.setup_seconds[step] = (self.setup_seconds.get(step, 0.0)
                                    + time.perf_counter() - t0)
        return out

    def _assemble_levels(self, n_levels: int, make_op, make_transfer,
                         free_masks) -> None:
        """Level i (coarse first): ``make_op(i)``, its smoother with start
        vectors masked by ``free_masks[i]``, ``make_transfer(i)`` from
        level i - 1."""
        levels = []
        for i in range(n_levels):
            op = self._timed("operators", make_op, i)
            if i == 0:
                sm = self._timed(
                    "eigenvalues", make_chebyshev, op, smoothing_range=1e-3,
                    degree=None, eig_cg_n_iterations=op.n_dofs,
                    free_mask=free_masks[i])
            else:
                sm = self._timed(
                    "eigenvalues", make_chebyshev, op, smoothing_range=15.0,
                    degree=5, eig_cg_n_iterations=10,
                    free_mask=free_masks[i])
            tr = self._timed("transfers", make_transfer, i) if i else None
            levels.append(MGLevel(op=op, smoother=sm, transfer=tr))
        self.levels = tuple(levels)

    def _solve(self, rhs: np.ndarray, rtol: float, graph: bool):
        b = torch.as_tensor(np.asarray(rhs, np.float64).reshape(-1),
                            dtype=self.dtype, device=self.device)
        res = cg(self.fine_operator.apply, b, self.preconditioner(
            graph=graph).apply, rtol=rtol)
        stats = SolveStats(
            iterations=res.iterations,
            residual_norm=res.residual_norm,
            converged=res.converged,
            solution_l2_norm=float(np.linalg.norm(_host(res.x))),
            n_dofs=self.fine_operator.n_dofs,
            dofs_per_level=[lvl.op.n_dofs for lvl in self.levels],
        )
        return res.x, stats


class UnstructuredMultigrid(_IndexedMultigrid):
    """h-multigrid Poisson on a FULLY unstructured hex/quad mesh hierarchy.

    The hierarchy comes from uniform refinement of an arbitrary coarse mesh
    (fem/general_mesh.py:refine_general_mesh — nested multilinear
    geometry), DoFs from the native orientation-matched enumerator, and the
    transfers are per-cell embedding contractions
    (ops/indexed.py:IndexedTransfer).  The unstructured analog of the
    reference's geometric driver (source/geometric_multigrid/program.cc).
    ``setup_seconds`` holds the steps ``refine``, ``enumerate``,
    ``operators`` (metric tables, diagonal, upload), ``eigenvalues`` and
    ``transfers``.
    """

    def __init__(
        self,
        gmesh_coarse: GeneralMesh,
        degree: int,
        n_refinements: int,
        dtype=torch.float64,
        device="cuda",
    ):
        from ..fem.general_mesh import refine_general_mesh
        from ..native import enumerate_dofs
        from ..ops.indexed import (
            make_unstructured_h_transfer,
            make_unstructured_laplace,
        )

        super().__init__(dtype, device)
        self.degree = degree
        meshes = [gmesh_coarse]
        for _ in range(n_refinements):
            meshes.append(self._timed("refine", refine_general_mesh,
                                      meshes[-1]))
        self.meshes = meshes
        self.dof_packs = [self._timed("enumerate", enumerate_dofs, m, degree)
                          for m in meshes]
        packs = self.dof_packs
        self._assemble_levels(
            len(meshes),
            lambda i: make_unstructured_laplace(meshes[i], degree, dtype,
                                                dofs=packs[i],
                                                device=self.device),
            lambda i: make_unstructured_h_transfer(
                meshes[i - 1], degree, packs[i - 1], packs[i], dtype,
                self.device),
            [pack[2] for pack in packs])

    def output_vtu(self, filename: str, u) -> None:
        """Write the solution on the unstructured fine mesh to a .vtu file
        (vertex-sampled, the DataOut analog)."""
        from ..utils.vtu import vertex_values, write_vtu

        gm = self.meshes[-1]
        _, l2g, _ = self.dof_packs[-1]
        write_vtu(
            filename, gm,
            {"solution": vertex_values(gm, self.degree, l2g, _host(u))},
        )

    def solve(self, f=None, rtol: float = 1e-12, verbose: bool = False,
              graph: bool = True):
        """Solve -Δu = f (f ≡ 1 when None, like the reference driver);
        ``graph=False`` runs the V-cycle eagerly on a CUDA device."""
        from ..fem.assemble import assemble_rhs_indexed

        gm = self.meshes[-1]
        n_dofs, l2g, mask = self.dof_packs[-1]
        if f is None:
            f = lambda *c: np.ones_like(c[0])  # noqa: E731
        rhs = assemble_rhs_indexed(gm, l2g, self.degree, n_dofs, mask, f)
        x, stats = self._solve(rhs, rtol, graph)
        if verbose:
            print(
                f" {stats.n_dofs} unstructured DoFs (by level: "
                f"{', '.join(str(d) for d in stats.dofs_per_level)})"
            )
            print(f"  Solver converged in {stats.iterations} iterations.")
        return x, stats


def _structured_levels(model, dim: int, degree: int, refinements: int,
                       geometries) -> None:
    """Indexed operators on FESpace(HyperCubeMesh(dim, r), degree), r = 0..
    ``refinements``, with the geometries given by level, and the structured
    h-transfers between them on flat vectors."""
    model.spaces = [FESpace(HyperCubeMesh(dim, r), degree)
                    for r in range(refinements + 1)]
    sp = model.spaces

    def transfer(i):
        return FlatTransfer(
            coarse_shape=sp[i - 1].grid_shape, fine_shape=sp[i].grid_shape,
            inner=make_h_transfer(sp[i - 1], sp[i], model.dtype,
                                  model.device))

    model._assemble_levels(
        len(sp),
        lambda i: make_indexed_laplace(sp[i], geometries[i], model.dtype,
                                       model.device),
        transfer, [s.free_mask().reshape(-1) for s in sp])


class GeneralGeometryMultigrid(_IndexedMultigrid):
    """h-multigrid Poisson on a deformed (structured-topology) mesh.
    ``setup_seconds`` holds ``geometry`` (the coarsened vertex grids),
    ``operators``, ``eigenvalues`` and ``transfers``."""

    def __init__(
        self,
        gmesh: GeneralMesh,
        degree: int,
        refinements: int,
        dtype=torch.float64,
        device="cuda",
    ):
        """gmesh: deformed mesh with structured topology and 2^refinements
        cells per axis (e.g. from fem.general_mesh.perturbed_cube_mesh)."""
        super().__init__(dtype, device)
        dim = gmesh.dim
        meshes = [gmesh]
        for r in range(refinements, 0, -1):
            meshes.append(self._timed("geometry", coarsen_vertex_grid,
                                      meshes[-1], dim, 1 << r))
        self.gmeshes = meshes[::-1]  # coarsest first
        _structured_levels(self, dim, degree, refinements, self.gmeshes)

    def output_vtu(self, filename: str, u) -> None:
        """Write the solution on the deformed fine mesh to a .vtu file."""
        from ..utils.vtu import vertex_values, write_vtu

        sp = self.spaces[-1]
        write_vtu(
            filename, self.gmeshes[-1],
            {"solution": vertex_values(
                self.gmeshes[-1], sp.degree, sp.local_to_global(),
                _host(u))},
        )

    def solve(self, rhs: np.ndarray | None = None, rtol: float = 1e-12,
              verbose: bool = False, graph: bool = True):
        """rhs defaults to a masked random vector (no general-geometry host
        quadrature for f; pass your own assembled rhs for a specific f)."""
        fine_sp = self.spaces[-1]
        if rhs is None:
            rng = np.random.default_rng(0)
            rhs = rng.standard_normal(fine_sp.n_dofs) * (
                fine_sp.free_mask().reshape(-1)
            )
        x, stats = self._solve(rhs, rtol, graph)
        if verbose:
            print(f"  Solver converged in {stats.iterations} iterations.")
        return x, stats


class CurvedMultigrid(_IndexedMultigrid):
    """h-multigrid Poisson on a genuinely CURVED domain: every level's
    operator carries the Q_q (MappingQ-analog) geometry evaluated from the
    same smooth transform (reference:
    include/operators/portable_laplace_operator.h:469-482).

    Levels are structured in REFERENCE space (transfers act on reference
    DoFs, geometry-independent); each level's control points sample the
    transform at its own cells' Gauss-Lobatto nodes, so coarse levels are
    the Q_q interpolant of the same manifold — standard isoparametric
    geometric multigrid.  ``mapping_degree`` defaults to the FE degree.
    ``setup_seconds`` holds ``geometry`` (the control points),
    ``operators``, ``eigenvalues`` and ``transfers``.
    """

    def __init__(
        self,
        dim: int,
        degree: int,
        refinements: int,
        transform,
        mapping_degree: int | None = None,
        dtype=torch.float64,
        device="cuda",
    ):
        from ..fem.general_mesh import curved_structured_geometry

        super().__init__(dtype, device)
        self.transform = transform
        q = degree if mapping_degree is None else mapping_degree
        self.mapping_degree = q
        self.geos = [
            self._timed("geometry", curved_structured_geometry, dim, 1 << r,
                        transform, q)
            for r in range(refinements + 1)
        ]
        _structured_levels(self, dim, degree, refinements, self.geos)

    def solve(self, f, rtol: float = 1e-12, verbose: bool = False,
              graph: bool = True):
        """Solve -Δu = f on the curved domain with V(2,2)-preconditioned CG."""
        from ..fem.assemble import assemble_rhs_indexed

        sp = self.spaces[-1]
        rhs = assemble_rhs_indexed(
            self.geos[-1], sp.local_to_global(), sp.degree, sp.n_dofs,
            sp.free_mask().reshape(-1), f)
        x, stats = self._solve(rhs, rtol, graph)
        if verbose:
            print(f"  Solver converged in {stats.iterations} iterations.")
        return x, stats

    def l2_error(self, u, u_exact) -> float:
        from ..fem.assemble import l2_error_indexed

        sp = self.spaces[-1]
        return l2_error_indexed(
            self.geos[-1], sp.local_to_global(), sp.degree, _host(u), u_exact,
        )
