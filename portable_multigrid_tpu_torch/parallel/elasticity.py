"""The slab-sharded linear-elasticity multigrid solve.

Counterpart of ``portable_multigrid_tpu/parallel/elasticity.py``: the
solve of ``models/elasticity.py`` with cell slabs along grid axis 0 on a
list of devices, one shard each, as ``parallel/poisson.py`` cuts the
Poisson solve.  The vector field adds a leading component axis, so the
halo exchanges run on axis 1 and the inner products weight the duplicated
planes of every component.

The hierarchy starts at the first level with a cell slab per shard (r =
log2 S) and has no replicated levels, as the JAX package's.  Variants:
``"sumfac"`` (the JAX package's default) runs the plain operator of
``ops/elasticity.py`` on every shard; ``"auto"`` (the JAX package's
``"pallas"``) runs B.5's slab instance (``ops/cuda_elasticity.py``
``CudaElasticitySlab``) on every 3D float32 level, ``sumfac`` elsewhere.
The smoother is the plain ``Chebyshev`` over the sharded operator on every
level, its bounds from CG-Lanczos on a single-device ``kron`` twin of
each level on the first device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..fem.assemble import assemble_rhs, l2_norm
from ..fem.mesh import HyperCubeMesh
from ..fem.space import FESpace
from ..ops.cuda_elasticity import cuda_elasticity_slab_from_factors
from ..ops.elasticity import (
    ElasticityOperator,
    assembled_1d_gradient,
    make_elasticity,
)
from ..ops.laplace import (
    assembled_1d_matrices,
    diagonal_1d_factors,
    quadrature_metric,
)
from ..solvers.cg import cg
from ..solvers.chebyshev import Chebyshev, _pseudo_random_grid
from ..solvers.vcycle import MGLevel, VCycle
from ..utils.tensors import to_tensor
from .poisson import (
    ShardedSolveStats,
    _bounds,
    _build_stacked_h_transfer,
    _partial_assembled_1d,
    default_devices,
    slab_eligible,
)
from .sharding import (
    ShardedCudaElasticity,
    ShardedElasticityOperator,
    ShardedField,
    dot_weights_axis0,
    make_sharded_dot,
    partition_axis0,
    unpartition_axis0,
)

VARIANTS = ("sumfac", "auto")


def _partial_assembled_gradient(space: FESpace, n_cells: int) -> np.ndarray:
    """The 1D gradient matrix G[i, j] = ∫ l_i' l_j assembled over n_cells
    cells only (a slab's): as ``_partial_assembled_1d`` for K and M."""
    b, p = space.basis, space.degree
    Gc = b.D.T @ np.diag(b.q_weights) @ b.B
    w = n_cells * p + 1
    G = np.zeros((w, w))
    for c in range(n_cells):
        sl = slice(c * p, c * p + p + 1)
        G[sl, sl] += Gc
    return G


def _build_stacked_elasticity(space: FESpace, devices, dtype, mu: float,
                              lam: float, variant: str = "sumfac"
                              ) -> ShardedElasticityOperator:
    """The plain operator on each shard: the slab's x extent, the shard's
    slices of the global x mask and diagonal factors (so that its diagonal
    is its slice of the assembled one and duplicated planes carry the
    global values), the global factors of the other axes; ``kron`` with the
    slab-partial x matrices."""
    dim, b = space.dim, space.basis
    n, p = space.mesh.cells_per_axis, space.degree
    S = len(devices)
    m1 = space.free_mask_1d()
    gK, gM = diagonal_1d_factors(space)
    parts = [partition_axis0(v, n, p, S) for v in (m1, gK, gM)]
    if variant == "kron":
        K1, M1 = assembled_1d_matrices(space)
        G1 = assembled_1d_gradient(space)
        K0, M0 = _partial_assembled_1d(space, n // S)
        G0 = _partial_assembled_gradient(space, n // S)
    elif variant != "sumfac":
        raise ValueError(f"sharded elasticity operator variant {variant!r}: "
                         f"the slabs run 'sumfac' or 'kron'")
    local = []
    for s, dev in enumerate(devices):
        t = functools.partial(to_tensor, dtype=dtype, device=dev)

        def sep(x, v):
            return (t(x),) + (t(v),) * (dim - 1)

        fields = dict(mask1=sep(parts[0][s], m1), dK1=sep(parts[1][s], gK),
                      dM1=sep(parts[2][s], gM))
        if variant == "kron":
            fields.update(Kg=sep(K0, K1), Mg=sep(M0, M1), Gg=sep(G0, G1))
        else:
            fields.update(B=t(b.B), Dco=t(b.Dco),
                          qmetric=t(quadrature_metric(space)))
        local.append(ElasticityOperator(
            dim=dim, degree=p, n=(n // S,) + (n,) * (dim - 1), mu=float(mu),
            lam=float(lam), variant=variant, **fields))
    return ShardedElasticityOperator(local=tuple(local))


def sharded_cuda_elasticity(space: FESpace, devices, dtype, mu: float,
                            lam: float, slices=None) -> ShardedCudaElasticity:
    """B.5's slab instance on each shard, in float32 or float64 (3D, the
    cells split evenly): the x factors are the shard's slices of the global
    mask and diagonal factors (``slices``: per shard (mask, dK, dM) where
    they come from elsewhere) and the slab-partial 1D assembly; the thin
    rows the last row of the slab-partial K, M, G and H = G^T over its last
    p+1 planes, the x mask on those columns folded in, and their sums in
    float64."""
    S = len(devices)
    n, p = space.mesh.cells_per_axis, space.degree
    if space.dim != 3 or n % S:
        raise ValueError(f"B.5's slab takes a 3D level whose {n} cells "
                         f"split into {S} slabs")
    n_loc, L = n // S, n // S * p
    K1, M1 = assembled_1d_matrices(space)
    G1 = assembled_1d_gradient(space)
    m1 = space.free_mask_1d()
    gK, gM = diagonal_1d_factors(space)
    Kp, Mp = _partial_assembled_1d(space, n_loc)
    Gp = _partial_assembled_gradient(space, n_loc)
    if slices is None:
        slices = list(zip(*(partition_axis0(v, n, p, S)
                            for v in (m1, gK, gM))))
    local = []
    rows = {k: [] for k in ("kx", "mx", "gx", "hx", "ks", "gs", "hs")}
    for s, dev in enumerate(devices):
        mx, gKx, gMx = (np.asarray(v, np.float64) for v in slices[s])
        local.append(cuda_elasticity_slab_from_factors(
            p, n, n_loc, m1, K1, M1, G1, gK, gM, mu, lam, mx, Kp, Mp, Gp,
            gKx, gMx, dtype, dev))
        cols = mx[L - p:]
        last = {"k": Kp[-1, -(p + 1):], "m": Mp[-1, -(p + 1):],
                "g": Gp[-1, -(p + 1):], "h": Gp[-(p + 1):, -1]}

        t = functools.partial(to_tensor, dtype=dtype, device=dev)
        for k, row in last.items():
            rows[k + "x"].append(t(row * cols))
            if k != "m":
                rows[k + "s"].append(t(np.sum(row * cols)))
    return ShardedCudaElasticity(local=tuple(local),
                                 **{f"thin_{k}": tuple(v)
                                    for k, v in rows.items()})


def _build_stacked_cuda_elasticity(space: FESpace, devices, dtype, mu: float,
                                   lam: float) -> ShardedCudaElasticity | None:
    """B.5's slab on each shard (the JAX package's
    ``_build_stacked_pallas_elasticity``), or None where the level is not
    eligible: 3D, float32 (as the JAX package builds its slab kernel), a
    whole number of cells per shard.  The TPU block pickers, lane padding
    and compile probes are not the port's: its kernel takes any extent."""
    if not slab_eligible(space, len(devices), dtype):
        return None
    return sharded_cuda_elasticity(space, devices, dtype, mu, lam)


def shard_vector(arr, n_cells: int, degree: int, devices,
                 dtype) -> ShardedField:
    """A global [dim, N, ...] field (NumPy) as a field on ``devices``, one
    slab of every component each."""
    st = np.stack([partition_axis0(np.asarray(a), n_cells, degree,
                                   len(devices)) for a in arr], 1)
    return ShardedField(torch.as_tensor(a, dtype=dtype, device=dev)
                        for a, dev in zip(st, devices))


class ShardedElasticity:
    """h-multigrid linear elasticity on slabs over a list of devices (every
    CUDA card by default; a device may repeat, ``[torch.device("cpu")] *
    S`` runs S shards on the CPU).  The shard count must be a power of
    two."""

    def __init__(self, dim: int, degree: int, refinements: int,
                 mu: float = 1.0, lam: float = 1.0, devices=None,
                 dtype=torch.float64, variant: str = "sumfac"):
        devices = default_devices() if devices is None else devices
        self.devices = [torch.device(d) for d in devices]
        S = len(self.devices)
        if S < 1 or S & (S - 1):
            raise ValueError("the number of shards must be a power of two")
        if variant not in VARIANTS:
            raise ValueError(f"unknown sharded variant {variant!r}; the port "
                             f"has {VARIANTS} ('auto': the JAX package's "
                             f"'pallas')")
        self.n_shards, self.dtype, self.dim = S, dtype, dim
        self.degree, self.variant = degree, variant
        self.mu, self.lam = float(mu), float(lam)
        min_ref = max(int(math.ceil(math.log2(S))), 0)
        if refinements < min_ref:
            raise ValueError(f"need >= {min_ref} refinements for {S} shards")
        self.spaces = [FESpace(HyperCubeMesh(dim, r), degree)
                       for r in range(min_ref, refinements + 1)]
        levels = []
        for i, sp in enumerate(self.spaces):
            op = None
            if variant == "auto":
                op = _build_stacked_cuda_elasticity(sp, self.devices, dtype,
                                                    mu, lam)
            if op is None:
                op = _build_stacked_elasticity(sp, self.devices, dtype, mu,
                                               lam)
            twin = make_elasticity(sp, dtype, mu, lam, device=self.devices[0])
            v0 = (_pseudo_random_grid((dim,) + sp.grid_shape)
                  * sp.free_mask()[None])
            v0 = torch.as_tensor(v0, dtype=dtype, device=twin.device)
            if i == 0:
                theta, delta, deg = _bounds(twin, True,
                                            min(twin.n_dofs, 128), dtype, v0)
            else:
                theta, delta, deg = _bounds(twin, False, 10, dtype, v0)
            del twin, v0
            transfer = None
            if i > 0:
                transfer = _build_stacked_h_transfer(
                    self.spaces[i - 1], sp, self.devices, dtype, halo_axis=1)
            levels.append(MGLevel(op=op, smoother=Chebyshev(
                degree=deg, op=op, theta=theta, delta=delta),
                transfer=transfer))
        self.levels = tuple(levels)
        fine = self.spaces[-1]
        w = dot_weights_axis0(fine.mesh.cells_per_axis, degree, S)
        self.dot = make_sharded_dot(
            [torch.as_tensor(v, dtype=dtype, device=dev)
             for v, dev in zip(w, self.devices)], dim, lead_axes=1)

    @property
    def fine_operator(self):
        """The operator CG runs on."""
        return self.levels[-1].op

    def preconditioner(self, pre_smoothing_steps: int = 2,
                       post_smoothing_steps: int = 2) -> VCycle:
        """The V-cycle on sharded fields, run eagerly."""
        return VCycle(levels=self.levels,
                      pre_smoothing_steps=pre_smoothing_steps,
                      post_smoothing_steps=post_smoothing_steps)

    def rhs(self) -> ShardedField:
        """The load vector of f ≡ (1, ..., 1) as a sharded field."""
        fine = self.spaces[-1]
        b = assemble_rhs(fine)
        return shard_vector(np.broadcast_to(b[None], (self.dim,) + b.shape),
                            fine.mesh.cells_per_axis, fine.degree,
                            self.devices, self.dtype)

    def gather(self, x: ShardedField) -> np.ndarray:
        """A sharded fine-level field as one global [dim, N, ...] array."""
        fine = self.spaces[-1]
        parts = [t.detach().cpu().numpy() for t in x.parts]
        return np.stack([unpartition_axis0([t[c] for t in parts],
                                           fine.mesh.cells_per_axis,
                                           fine.degree, self.n_shards)
                         for c in range(self.dim)])

    def solve(self, rtol: float = 1e-12, verbose: bool = False):
        """CG with the sharded V-cycle; returns the global solution [dim, N,
        ...] (NumPy, in the solve's dtype) and :class:`ShardedSolveStats`
        (DoFs counted over the components, the L2 norm over them)."""
        fine = self.spaces[-1]
        res = cg(self.fine_operator.apply, self.rhs(),
                 self.preconditioner().apply, rtol=rtol, dot=self.dot)
        x = self.gather(res.x)
        norm = float(np.sqrt(sum(l2_norm(fine, x[c].astype(np.float64)) ** 2
                                 for c in range(self.dim))))
        stats = ShardedSolveStats(
            iterations=res.iterations, residual_norm=res.residual_norm,
            converged=res.converged, solution_l2_norm=norm,
            n_dofs=self.dim * fine.n_dofs, n_shards=self.n_shards,
            dofs_per_level=[self.dim * sp.n_dofs for sp in self.spaces])
        if verbose:
            print(f" Number of degrees of freedom: {stats.n_dofs} over "
                  f"{self.n_shards} shards")
            print(f"  Solver converged in {stats.iterations} iterations.")
            print(f"  solution norm: {stats.solution_l2_norm:.6g}")
        return x, stats
