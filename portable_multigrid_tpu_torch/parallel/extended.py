"""Any shard count, by padding the sharded axis with dead cells.

Counterpart of ``portable_multigrid_tpu/parallel/extended.py``.  The
reference runs under any ``mpirun -n N`` (reference:
source/geometric_multigrid/program.cc:452), where deal.II hands each rank
an uneven slab.  The slab machinery of ``parallel/sharding.py`` takes
uniform slabs, so for S shards the sharded axis is padded with dead cells
up to n_ext = S 2^k (k = refinements - floor(log2 S)), on the same
lattice spacing:

  * the dead DoFs (x > 1) are masked as constrained: their rows of the
    effective operator are the identity, the rhs is zero there and the
    transfers give them zero weight, so the live block is the unit-cube
    problem itself (the interface plane x = 1 was a Dirichlet plane
    already);
  * every extended level has a multiple of S cells, so the whole
    hierarchy shards into uniform slabs, down to the S-cell coarsest level
    (one cell a shard), which runs the reference's Chebyshev-as-solver;
  * the padding costs S / 2^floor(log2 S) in [1, 2) along the sharded
    axis (6 shards: 1.5x), as masked work, not more iterations.

The hierarchy stops at S cells where the power-of-two path reaches one,
so the CG count need not equal the single device's; the live solution
does, to solver tolerance.  Every level runs the plain ``kron`` operator,
as in the JAX package, which reaches no Pallas kernel here.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..fem.assemble import assemble_rhs
from ..fem.basis import h_prolongation_matrix_1d
from ..fem.mesh import HyperCubeMesh
from ..fem.space import FESpace
from ..ops.laplace import (
    LaplaceOperator,
    assembled_1d_matrices,
    diagonal_1d_factors,
)
from ..ops.transfer import _weights_1d
from ..solvers.chebyshev import (
    Chebyshev,
    _host_free_mask,
    _pseudo_random_grid,
    chebyshev_bounds,
    estimate_eigenvalues,
    np_dtype,
)
from ..solvers.vcycle import MGLevel
from .poisson import (
    ShardedGeometricPoisson,
    ShardedSolveStats,
    _build_stacked_operator,
    _partial_assembled_1d,
    _stacked_transfer,
    default_devices,
)
from .sharding import (
    dot_weights_axis0,
    make_sharded_dot,
    shard,
    unpartition_axis0,
)

# the coarsest level's bounds come from a dense eigensolve on the host up
# to this many grid points (the JAX package's rule, extended.py:170-172)
DENSE_COARSE_POINTS = 20000


def _ext_mask0(n0: int, live: int, p: int) -> np.ndarray:
    """The x free mask on the extended grid of n0 cells: Dirichlet at x = 0
    and x = 1 (plane live p), the dead region beyond constrained."""
    m = np.zeros(n0 * p + 1)
    m[1:live * p] = 1.0
    return m


def _ext_axis0_level(sp: FESpace, n0: int) -> tuple:
    """(K0, M0, mask0, dK0, dM0) of the extended x lattice of n0 cells at
    the level's spacing: the 1D assembly over all n0 cells, the mask apart,
    and its diagonals."""
    K0, M0 = _partial_assembled_1d(sp, n0)
    m0 = _ext_mask0(n0, sp.mesh.cells_per_axis, sp.degree)
    return K0, M0, m0, np.diag(K0).copy(), np.diag(M0).copy()


def _dense_coarse_bounds(sp: FESpace, n0: int) -> tuple[float, float]:
    """The exact extreme eigenvalues of the Jacobi-preconditioned coarsest
    extended operator from a dense eigensolve on the host (the level is
    small; Lanczos over hundreds of iterations breaks down at low
    precision there)."""
    K1, M1 = assembled_1d_matrices(sp)
    m1 = sp.free_mask_1d()
    K0, M0, m0, _, _ = _ext_axis0_level(sp, n0)

    def msk(A, m):
        return m[:, None] * A * m[None, :]

    K0m, M0m = msk(K0, m0), msk(M0, m0)
    K1m, M1m = msk(K1, m1), msk(M1, m1)
    if sp.dim == 3:
        A = (np.kron(K0m, np.kron(M1m, M1m))
             + np.kron(M0m, np.kron(K1m, M1m))
             + np.kron(M0m, np.kron(M1m, K1m)))
        mask = np.kron(m0, np.kron(m1, m1))
    else:
        A = np.kron(K0m, M1m) + np.kron(M0m, K1m)
        mask = np.kron(m0, m1)
    A = A + np.diag(1.0 - mask)
    dinv = 1.0 / np.sqrt(np.diag(A))
    ev = np.linalg.eigvalsh(dinv[:, None] * A * dinv[None, :])
    return float(ev[0]), float(ev[-1])


def _ext_operator(sp: FESpace, n0: int, dtype=torch.float64,
                  device="cpu") -> LaplaceOperator:
    """The single-device ``kron`` operator on the whole extended
    (anisotropic) grid: n0 cells along x, the level's along y and z."""
    dim = sp.dim
    K1, M1 = assembled_1d_matrices(sp)
    K0, M0, m0, dK0, dM0 = _ext_axis0_level(sp, n0)
    m1 = sp.free_mask_1d()
    gK, gM = diagonal_1d_factors(sp)

    def axes(x, v):
        return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                     for a in (x,) + (v,) * (dim - 1))

    return LaplaceOperator(
        dim=dim, degree=sp.degree,
        n=(n0,) + (sp.mesh.cells_per_axis,) * (dim - 1), variant="kron",
        mask1=axes(m0, m1), dK1=axes(dK0, gK), dM1=axes(dM0, gM),
        Kg=axes(K0, K1), Mg=axes(M0, M1))


class ExtendedShardedPoisson(ShardedGeometricPoisson):
    """h-multigrid Poisson on slabs over ANY number of shards (``kron`` on
    every level): the sharded axis padded with dead cells to S 2^k.  The
    devices default to every CUDA card, and a device may repeat
    (``[torch.device("cuda", 0)] * 3`` runs three shards on one card)."""

    def __init__(self, dim: int, degree: int, refinements: int,
                 devices=None, dtype=torch.float64):
        self._set_devices(devices, dtype)
        S = self.n_shards
        self.dim, self.degree = dim, degree
        self.variant = "kron"
        self.sharded_setup = False
        self.n_replicated = 0
        f = int(math.floor(math.log2(S)))
        if refinements < f:
            raise ValueError(f"need >= {f} refinements for {S} shards")
        k = refinements - f
        # level j = 0..k: n0 = S 2^j extended cells, 2^(f+j) live
        self.spaces = [FESpace(HyperCubeMesh(dim, f + j), degree)
                       for j in range(k + 1)]
        self.n0s = [S << j for j in range(k + 1)]
        dt = np_dtype(dtype)
        levels = []
        for j, (sp, n0) in enumerate(zip(self.spaces, self.n0s)):
            coarse = j == 0
            if coarse and ((n0 * degree + 1) * sp.points_per_axis ** (dim - 1)
                           <= DENSE_COARSE_POINTS):
                mn, mx = _dense_coarse_bounds(sp, n0)
            else:
                twin = _ext_operator(sp, n0, dtype, self.devices[0])
                v0 = _pseudo_random_grid(twin.shape) * _host_free_mask(twin)
                mn, mx = estimate_eigenvalues(
                    twin, min(twin.n_dofs, 256) if coarse else 10,
                    torch.as_tensor(v0, dtype=dtype, device=twin.device))
                del twin
            alpha, beta, deg = (chebyshev_bounds(mn, mx, 1e-3, None)
                                if coarse else
                                chebyshev_bounds(mn, mx, 15.0, 5))
            op = self._build_op(sp, n0)
            smoother = Chebyshev(degree=deg, op=op,
                                 theta=float(dt((beta + alpha) / 2.0)),
                                 delta=float(dt((beta - alpha) / 2.0)))
            transfer = None if coarse else self._build_transfer(
                self.spaces[j - 1], self.n0s[j - 1], sp, n0)
            levels.append(MGLevel(op=op, smoother=smoother,
                                  transfer=transfer))
        self.levels = tuple(levels)
        self.dot = self._dot(self.spaces[-1])

    def _set_devices(self, devices, dtype):
        """Any number of shards (the power-of-two rule of the cube path
        does not apply)."""
        self.devices = [torch.device(d) for d in (
            default_devices() if devices is None else devices)]
        if not self.devices:
            raise ValueError("no devices")
        self.n_shards = len(self.devices)
        self.dtype = dtype

    def _build_op(self, sp: FESpace, n0: int):
        """The ``kron`` operator on each shard's slab of the extended
        level: the slab-partial x assembly, the shard's slices of the
        extended x mask and diagonals."""
        _, _, m0, dK0, dM0 = _ext_axis0_level(sp, n0)
        return _build_stacked_operator(sp, self.devices, self.dtype, "kron",
                                       axis0=(n0, m0, dK0, dM0))

    def _build_transfer(self, csp: FESpace, cn0: int, fsp: FESpace,
                        fn0: int):
        """The h-transfer between two extended levels: the x weights and
        masks those of the extended lattices (zero on the dead DoFs)."""
        p = csp.degree
        n_c = csp.mesh.cells_per_axis
        wf0 = _weights_1d(cn0, 2 * p) * _ext_mask0(
            fn0, fsp.mesh.cells_per_axis, p)
        mc0 = _ext_mask0(cn0, n_c, p)
        wf = _weights_1d(n_c, 2 * p) * fsp.free_mask_1d()
        return _stacked_transfer(n_c, p, 2 * p, h_prolongation_matrix_1d(p),
                                 wf, csp.free_mask_1d(), csp.dim,
                                 self.devices, self.dtype,
                                 axis0=(cn0, wf0, mc0))

    def _dot(self, space: FESpace):
        w = dot_weights_axis0(self.n0s[-1], space.degree, self.n_shards)
        return make_sharded_dot(
            [torch.as_tensor(v, dtype=self.dtype, device=dev)
             for v, dev in zip(w, self.devices)], space.dim)

    def rhs(self):
        """The unit-cube load vector of f ≡ 1 embedded in the extended
        grid (zero on the dead region), as a sharded field."""
        fine = self.spaces[-1]
        live = assemble_rhs(fine)
        ext = np.zeros((self.n0s[-1] * fine.degree + 1,) + live.shape[1:])
        ext[:fine.points_per_axis] = live
        return shard(ext, self.n0s[-1], fine.degree, self.devices,
                     self.dtype)

    def gather(self, x) -> np.ndarray:
        """The live region of a sharded fine-level field (NumPy)."""
        fine = self.spaces[-1]
        ext = unpartition_axis0([t.detach().cpu().numpy() for t in x.parts],
                                self.n0s[-1], fine.degree, self.n_shards)
        return ext[:fine.points_per_axis]

    def _header(self, stats: ShardedSolveStats) -> str:
        fine = self.spaces[-1]
        return (f" {stats.n_dofs} live DoFs over {stats.n_shards} shards "
                f"(extended axis: {self.n0s[-1]} cells, live "
                f"{fine.mesh.cells_per_axis})")
