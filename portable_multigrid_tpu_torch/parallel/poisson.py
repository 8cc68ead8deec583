"""The slab-sharded multigrid Poisson solve.

Counterpart of ``portable_multigrid_tpu/parallel/poisson.py``: the solve of
``models/poisson.py`` (CG, the V-cycle, the smoothers, the transfers and
the operator) with cell slabs along grid axis 0 on a list of devices, one
shard each, and single planes exchanged between neighbours
(``parallel/sharding.py``); the counterpart of running the reference's
drivers under ``mpirun -n N`` (reference:
source/geometric_multigrid/program.cc:73-75,124-132,452).

Level layout: a level with at least one cell slab per shard is sharded;
the levels below that granularity are replicated on every shard (the same
work on the same data, entered through ``sharding.GatherTransfer``), so
that the hierarchy reaches the one-cell base mesh as the reference's does
(source/geometric_multigrid/program.cc:137-147) and the CG counts match
the single-device solver's.

Variants: ``"sumfac"`` (the JAX package's default) and ``"kron"`` run the
plain operator of ``ops/laplace.py`` on every shard; ``"auto"`` (the JAX
package's ``"pallas"``) runs the kernel path on every float32 sharded
level: B.1's slab instance for the operator and the residuals, its
``"mxu"`` core for the Chebyshev recurrence and B.2's ``xext`` pair where
a slab holds at least two cells (``PMG_CHEB2=0`` drops the pairs, as in
the JAX package), all at float32 state; the other levels run ``kron``.

The smoothers' eigenvalue bounds come from a single-device twin of each
level operator on the first device (the kernel operator of
``ops/cuda_laplace.py`` on a kernel level, ``sumfac`` elsewhere), or with
``sharded_setup`` from CG-Lanczos on the sharded operator itself.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os

import numpy as np
import torch

from ..fem.assemble import assemble_rhs, l2_norm
from ..fem.basis import h_prolongation_matrix_1d, p_prolongation_matrix_1d
from ..fem.mesh import HyperCubeMesh
from ..fem.space import FESpace
from ..ops.cuda_cheb2 import make_cheb2_xext
from ..ops.cuda_laplace import (
    cuda_laplace_slab_from_factors,
    make_cuda_laplace,
)
from ..ops.laplace import (
    LaplaceOperator,
    assembled_1d_matrices,
    diagonal_1d_factors,
    make_laplace,
    quadrature_metric,
)
from ..ops.transfer import Transfer, _weights_1d, make_h_transfer
from ..solvers.cg import cg
from ..solvers.chebyshev import (
    Chebyshev,
    _pseudo_random_grid,
    chebyshev_bounds,
    estimate_eigenvalues,
    np_dtype,
)
from ..solvers.vcycle import MGLevel, VCycle
from ..utils.tensors import to_tensor
from .sharding import (
    GatherTransfer,
    Replicated,
    ShardedCudaLaplace,
    ShardedFusedChebyshev,
    ShardedLaplaceOperator,
    ShardedTransfer,
    dot_weights_axis0,
    estimate_eigenvalues_sharded,
    make_sharded_dot,
    partition_axis0,
    per_device,
    shard,
    unpartition_axis0,
)

VARIANTS = ("sumfac", "kron", "auto")


def default_devices() -> list:
    """Every CUDA card, as the JAX default is every device; raises where
    there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the sharded solve runs on the "
                           "cards; pass devices=[torch.device('cpu')] * S "
                           "to run S shards on the CPU")
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def _partial_assembled_1d(space: FESpace, n_cells: int):
    """The 1D stiffness and mass assembled over n_cells cells only (a slab's
    matrices): its boundary rows carry the slab's own cells, and the halo
    exchange completes them (slicing the global assembly would count a
    shared plane's diagonal twice)."""
    b = space.basis
    p = space.degree
    W = np.diag(b.q_weights)
    Kc = (b.D.T @ W @ b.D) / space.mesh.h
    Mc = (b.B.T @ W @ b.B) * space.mesh.h
    w = n_cells * p + 1
    K = np.zeros((w, w))
    M = np.zeros((w, w))
    for c in range(n_cells):
        sl = slice(c * p, c * p + p + 1)
        K[sl, sl] += Kc
        M[sl, sl] += Mc
    return K, M


def _build_stacked_operator(space: FESpace, devices, dtype,
                            variant: str = "sumfac",
                            axis0=None) -> ShardedLaplaceOperator:
    """The plain operator on each shard: the slab's x extent, the shard's
    slices of the global x mask and diagonal factors (so that duplicated
    planes carry the global values), the global factors of the other
    axes; ``kron`` with the slab-partial x matrices.  ``axis0`` = (cells,
    mask, dK, dM): the x axis's own cell count and global vectors where
    they differ from the cube's (the extended domain of
    ``parallel/extended.py``; ``kron`` only)."""
    b, dim = space.basis, space.dim
    n, p = space.mesh.cells_per_axis, space.degree
    S = len(devices)
    m1 = space.free_mask_1d()
    gK, gM = diagonal_1d_factors(space)
    n0, *x_vectors = (n, m1, gK, gM) if axis0 is None else axis0
    parts = [partition_axis0(v, n0, p, S) for v in x_vectors]
    K1 = M1 = K0 = M0 = None
    if variant == "kron":
        K1, M1 = assembled_1d_matrices(space)
        K0, M0 = _partial_assembled_1d(space, n0 // S)
    elif axis0 is not None:
        raise ValueError("an operator with x factors of its own is 'kron'")
    if variant not in ("sumfac", "kron"):
        raise ValueError(f"sharded operator variant {variant!r}: the slabs "
                         f"run 'sumfac' or 'kron'")
    local = []
    for s, dev in enumerate(devices):
        t = functools.partial(to_tensor, dtype=dtype, device=dev)

        def sep(k, v):
            return (t(parts[k][s]),) + (t(v),) * (dim - 1)

        fields = dict(mask1=sep(0, m1), dK1=sep(1, gK), dM1=sep(2, gM))
        if variant == "kron":
            fields.update(Kg=(t(K0),) + (t(K1),) * (dim - 1),
                          Mg=(t(M0),) + (t(M1),) * (dim - 1))
        else:
            fields.update(B=t(b.B), Dco=t(b.Dco),
                          qmetric=t(quadrature_metric(space)))
        local.append(LaplaceOperator(
            dim=dim, degree=p, n=(n0 // S,) + (n,) * (dim - 1),
            variant=variant, **fields))
    return ShardedLaplaceOperator(local=tuple(local))


def _stacked_transfer(n_c: int, stride_c: int, stride_f: int, M1, wf, mc,
                      dim: int, devices, dtype, halo_axis: int = 0,
                      axis0=None) -> ShardedTransfer:
    """Per shard the separable transfer of its slab: the x weights and
    masks the shard's slices of the global ones (the fine grid's slabs at
    stride_f, the coarse grid's at stride_c); ``halo_axis`` 1 for fields
    with a leading component axis; ``axis0`` = (coarse cells, wf, mc): the
    x axis's own where they differ from the other axes' (the extended
    domain of ``parallel/extended.py``)."""
    S = len(devices)
    n_c0, wfx, mcx = (n_c, wf, mc) if axis0 is None else axis0
    wf0 = partition_axis0(wfx, n_c0, stride_f, S)
    mc0 = partition_axis0(mcx, n_c0, stride_c, S)
    local = []
    for s, dev in enumerate(devices):
        t = functools.partial(to_tensor, dtype=dtype, device=dev)
        local.append(Transfer(
            dim=dim, n_coarse=(n_c0 // S,) + (n_c,) * (dim - 1),
            stride_c=stride_c, stride_f=stride_f, M1=t(M1),
            wmask_f=(t(wf0[s]),) + (t(wf),) * (dim - 1),
            mask_c1=(t(mc0[s]),) + (t(mc),) * (dim - 1)))
    return ShardedTransfer(local=tuple(local), halo_axis=halo_axis)


def _build_stacked_h_transfer(coarse: FESpace, fine: FESpace, devices,
                              dtype, halo_axis: int = 0) -> ShardedTransfer:
    p, n_c = coarse.degree, coarse.mesh.cells_per_axis
    wf = _weights_1d(n_c, 2 * p) * fine.free_mask_1d()
    return _stacked_transfer(n_c, p, 2 * p, h_prolongation_matrix_1d(p), wf,
                             coarse.free_mask_1d(), coarse.dim, devices,
                             dtype, halo_axis)


def _build_stacked_p_transfer(coarse: FESpace, fine: FESpace, devices,
                              dtype) -> ShardedTransfer:
    """The polynomial transfer on each shard (one mesh, p_c < p_f)."""
    n, pc, pf = coarse.mesh.cells_per_axis, coarse.degree, fine.degree
    wf = _weights_1d(n, pf) * fine.free_mask_1d()
    return _stacked_transfer(n, pc, pf, p_prolongation_matrix_1d(pc, pf), wf,
                             coarse.free_mask_1d(), coarse.dim, devices,
                             dtype)


def slab_eligible(space: FESpace, S: int, dtype) -> bool:
    """Whether a level runs B.1's slab instance: 3D, float32 (as the JAX
    package builds its slab kernels), a whole number of cells per shard.
    The TPU kernel's lane, padding and 8-alignment conditions
    (pallas_laplace.py:913-934) are not the port's: its kernels take any
    extent."""
    return (space.dim == 3 and dtype == torch.float32
            and space.mesh.cells_per_axis % S == 0)


def _build_stacked_slab(space: FESpace, devices, dtype,
                        core: str = "banded") -> ShardedCudaLaplace | None:
    """B.1's slab instance on each shard (``core="mxu"``: the bf16 grade of
    the recurrence), or None where the level is not eligible: the x
    factors are the shard's slices of the global mask and diagonal factors
    and the slab-partial 1D assembly; the thin rows the last row of the
    slab-partial K and M over its last p+1 planes, the x mask folded in."""
    S = len(devices)
    if not slab_eligible(space, S, dtype):
        return None
    n, p = space.mesh.cells_per_axis, space.degree
    n_loc, L = n // S, n // S * p
    K1, M1 = assembled_1d_matrices(space)
    m1 = space.free_mask_1d()
    gK, gM = diagonal_1d_factors(space)
    Kp, Mp = _partial_assembled_1d(space, n_loc)
    mx, gKx, gMx = (partition_axis0(v, n, p, S) for v in (m1, gK, gM))
    local, kx, mxr, sx = [], [], [], []
    for s, dev in enumerate(devices):
        local.append(cuda_laplace_slab_from_factors(
            p, n, n_loc, m1, K1, M1, gK, gM, mx[s], Kp, Mp, gKx[s], gMx[s],
            dtype, dev, core))
        cols = mx[s][L - p:]

        t = functools.partial(to_tensor, dtype=dtype, device=dev)
        kx.append(t(Kp[-1, -(p + 1):] * cols))
        mxr.append(t(Mp[-1, -(p + 1):] * cols))
        # the row sum from the cut columns: a row of Kp sums to zero
        sx.append(t(-np.dot(Kp[-1, -(p + 1):], 1.0 - cols)))
    return ShardedCudaLaplace(local=tuple(local), thin_kx=tuple(kx),
                              thin_mx=tuple(mxr), thin_sx=tuple(sx))


def _build_stacked_cheb2(space: FESpace, devices, dtype,
                         core: str = "mxu") -> tuple | None:
    """B.2's xext pair on each shard (the JAX package's
    ``_build_stacked_cheb2``), made from the global operator at ``core``'s
    grade on the shard's device and marching the shard's planes, or None:
    a level not eligible for the slab, or slabs of one cell, whose 2p
    planes of halo would reach past the neighbour."""
    S = len(devices)
    if not slab_eligible(space, S, dtype):
        return None
    n, p = space.mesh.cells_per_axis, space.degree
    n_loc = n // S
    if n_loc < 2:
        return None
    ops = per_device(lambda dev: make_cuda_laplace(space, dtype, dev,
                                                   core=core), devices)
    L = n_loc * p
    return tuple(make_cheb2_xext(op, s * L, L) for s, op in enumerate(ops))


@dataclasses.dataclass
class ShardedSolveStats:
    iterations: int
    residual_norm: float
    converged: bool
    solution_l2_norm: float
    n_dofs: int
    n_shards: int
    dofs_per_level: list


def _bounds(twin, coarse: bool, n_iter: int, dtype, v0=None, dot=None):
    """(theta, delta, degree) of a level's smoother from CG-Lanczos on
    ``twin`` (a single-device operator, or with ``dot`` the sharded one),
    from the seeded start vector ``v0`` times the free mask: Chebyshev as
    the coarse solver (range 1e-3, adaptive degree) or the smoother (15,
    degree 5)."""
    if dot is None:
        mn, mx = estimate_eigenvalues(twin, n_iter, v0)
    else:
        mn, mx = estimate_eigenvalues_sharded(twin, dot, n_iter, v0)
    alpha, beta, deg = (chebyshev_bounds(mn, mx, 1e-3, None) if coarse
                        else chebyshev_bounds(mn, mx, 15.0, 5))
    dt = np_dtype(dtype)
    return float(dt((beta + alpha) / 2.0)), float(dt((beta - alpha) / 2.0)), deg


class ShardedGeometricPoisson:
    """h-multigrid Poisson solve on slabs over a list of devices (every CUDA
    card by default; a device may repeat, ``[torch.device("cpu")] * S``
    runs S shards on the CPU).  The shard count must be a power of two."""

    def __init__(self, dim: int, degree: int, refinements: int,
                 devices=None, dtype=torch.float64, variant: str = "sumfac",
                 sharded_setup: bool = False, replicate_coarse: bool = True):
        self._set_devices(devices, dtype)
        if variant not in VARIANTS:
            raise ValueError(f"unknown sharded variant {variant!r}; the port "
                             f"has {VARIANTS} ('auto': the JAX package's "
                             f"'pallas')")
        self.variant = variant
        self.sharded_setup = sharded_setup
        S = self.n_shards
        min_ref = max(int(math.ceil(math.log2(S))), 0)
        if refinements < min_ref:
            raise ValueError(f"need >= {min_ref} refinements to give every "
                             f"one of {S} shards a cell slab")
        self.n_replicated = min_ref if replicate_coarse else 0
        self.spaces = [FESpace(HyperCubeMesh(dim, r), degree)
                       for r in range(min_ref - self.n_replicated,
                                      refinements + 1)]
        self._build_levels(_build_stacked_h_transfer)

    def _set_devices(self, devices, dtype):
        devices = default_devices() if devices is None else devices
        self.devices = [torch.device(d) for d in devices]
        S = len(self.devices)
        if S < 1 or S & (S - 1):
            raise ValueError("the number of shards must be a power of two")
        self.n_shards = S
        self.dtype = dtype

    def _build_levels(self, transfer_builder) -> None:
        S, dtype, devices = self.n_shards, self.dtype, self.devices
        plain = "kron" if self.variant == "auto" else self.variant
        R = self.n_replicated
        levels = []
        for i, sp in enumerate(self.spaces):
            n, p = sp.mesh.cells_per_axis, sp.degree
            coarse = i == 0
            # the coarse level: eig-CG of m() = n_dofs iterations, as the
            # reference (source/geometric_multigrid/program.cc:274-279)
            n_iter = sp.n_dofs if coarse else 10
            v0 = _pseudo_random_grid(sp.grid_shape) * sp.free_mask()
            smooth_op = cheb2 = None
            if i < R:
                op = Replicated(per_device(
                    lambda dev: make_laplace(sp, dtype, plain, dev), devices))
                twin = op.local[0]
            else:
                op = None
                if self.variant == "auto":
                    op = _build_stacked_slab(sp, devices, dtype)
                    if op is not None and not coarse:
                        smooth_op = _build_stacked_slab(sp, devices, dtype,
                                                        core="mxu")
                        if os.environ.get("PMG_CHEB2", "1") == "1":
                            cheb2 = _build_stacked_cheb2(sp, devices, dtype)
                if op is None:
                    op = _build_stacked_operator(sp, devices, dtype, plain)
                twin = (make_cuda_laplace(sp, dtype, devices[0])
                        if isinstance(op, ShardedCudaLaplace)
                        else make_laplace(sp, dtype, "sumfac", devices[0]))
            if (self.sharded_setup and i >= R
                    and not isinstance(op, ShardedCudaLaplace)):
                theta, delta, deg = _bounds(
                    op, coarse, n_iter, dtype,
                    shard(v0, n, p, devices, dtype), self._dot(sp))
            else:
                theta, delta, deg = _bounds(
                    twin, coarse, n_iter, dtype,
                    torch.as_tensor(v0, dtype=dtype, device=twin.device))
            del twin
            if smooth_op is not None:
                smoother = ShardedFusedChebyshev(
                    degree=deg, op=op, op_smooth=smooth_op, theta=theta,
                    delta=delta, op_cheb2=cheb2)
            else:
                smoother = Chebyshev(degree=deg, op=op, theta=theta,
                                     delta=delta)
            if coarse:
                transfer = None
            elif i < R:
                transfer = Replicated(per_device(
                    lambda dev: make_h_transfer(self.spaces[i - 1], sp, dtype,
                                                dev), devices))
            elif i == R and R > 0:
                # the boundary pair: replicated coarse, sharded fine
                transfer = GatherTransfer(
                    local=per_device(
                        lambda dev: make_h_transfer(self.spaces[i - 1], sp,
                                                    dtype, dev), devices),
                    slab_stride=n // S * p, n_loc_points=n // S * p + 1)
            else:
                transfer = transfer_builder(self.spaces[i - 1], sp, devices,
                                            dtype)
            levels.append(MGLevel(op=op, smoother=smoother,
                                  transfer=transfer))
        self.levels = tuple(levels)
        self.dot = self._dot(self.spaces[-1])

    def _dot(self, space: FESpace):
        """The sharded inner product of a level's fields."""
        w = dot_weights_axis0(space.mesh.cells_per_axis, space.degree,
                              self.n_shards)
        return make_sharded_dot(
            [torch.as_tensor(v, dtype=self.dtype, device=dev)
             for v, dev in zip(w, self.devices)], space.dim)

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

    def rhs(self):
        """The load vector of f ≡ 1 as a sharded field."""
        fine = self.spaces[-1]
        return shard(assemble_rhs(fine), fine.mesh.cells_per_axis,
                     fine.degree, self.devices, self.dtype)

    def gather(self, x) -> np.ndarray:
        """A sharded fine-level field as one global NumPy array."""
        fine = self.spaces[-1]
        return unpartition_axis0([t.detach().cpu().numpy() for t in x.parts],
                                 fine.mesh.cells_per_axis, fine.degree,
                                 self.n_shards)

    def solve(self, rtol: float = 1e-12, pre_smoothing_steps: int = 2,
              post_smoothing_steps: int = 2, verbose: bool = False):
        """CG with the sharded V-cycle; returns the global solution (NumPy,
        in the solve's dtype) and :class:`ShardedSolveStats`."""
        fine = self.spaces[-1]
        mg = self.preconditioner(pre_smoothing_steps, post_smoothing_steps)
        res = cg(self.fine_operator.apply, self.rhs(), mg.apply, rtol=rtol,
                 dot=self.dot)
        x = self.gather(res.x)
        stats = ShardedSolveStats(
            iterations=res.iterations,
            residual_norm=res.residual_norm,
            converged=res.converged,
            solution_l2_norm=l2_norm(fine, x.astype(np.float64)),
            n_dofs=fine.n_dofs,
            n_shards=self.n_shards,
            dofs_per_level=[sp.n_dofs for sp in self.spaces],
        )
        if verbose:
            print(self._header(stats))
            print(f"  Solver converged in {stats.iterations} iterations.")
            print(f"  solution norm: {stats.solution_l2_norm:.6g}")
        return x, stats

    def _header(self, stats: ShardedSolveStats) -> str:
        """The first line that a verbose solve prints."""
        return (f" Number of degrees of freedom: {stats.n_dofs} over "
                f"{self.n_shards} shards (by level: "
                f"{', '.join(str(d) for d in stats.dofs_per_level)})")


class ShardedPolynomialPoisson(ShardedGeometricPoisson):
    """p-multigrid Poisson solve on slabs: one mesh, the degree ladder
    p_l = degree - (n_levels-1-l) (reference:
    source/polynomial_multigrid/program.cc:149-159), every level sharded
    into the same cell slabs, ``sumfac`` on each."""

    def __init__(self, dim: int, degree: int, refinements: int,
                 n_levels: int | None = None, devices=None,
                 dtype=torch.float64):
        self._set_devices(devices, dtype)
        self.variant = "sumfac"
        self.sharded_setup = False
        self.n_replicated = 0
        if n_levels is None:
            n_levels = degree
        if n_levels > degree:
            raise ValueError("n_levels must be <= degree")
        mesh = HyperCubeMesh(dim, refinements)
        if mesh.cells_per_axis % self.n_shards:
            raise ValueError(f"cells per axis ({mesh.cells_per_axis}) must "
                             f"be divisible by the shards "
                             f"({self.n_shards})")
        self.spaces = [FESpace(mesh, degree - (n_levels - 1 - l))
                       for l in range(n_levels)]
        self._build_levels(_build_stacked_p_transfer)
