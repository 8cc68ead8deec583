"""The 2D-pencil sharded multigrid Poisson solve.

Counterpart of ``portable_multigrid_tpu/parallel/mesh2d.py``: the cells
are cut along grid axes 0 AND 1 into (sx, sy) pencils, one per shard, with
the shared planes of both axes stored duplicated and consistent on both
neighbours (the 2D analog of ``parallel/sharding.py``'s slabs).  Where the
JAX package runs one ``shard_map`` program over a (sx, sy) device mesh,
the port runs one controller over a list of sx sy devices in row-major
order (shard (i, j) at index i sy + j; a device may repeat), and every
``ppermute``, ``psum`` and ``all_gather`` of the JAX module is plane
copies between the shards of one row or one column of the mesh:

  * :func:`~.sharding.halo_sum_2d` exchanges along x, then along y, so
    that the y exchange carries the x-completed planes and the points that
    four pencils share gather all four contributions;
  * the pair smoother's halos extend y first, then x of the y-extended
    state, and its full-pencil output appends the y neighbour's row, then
    the x neighbour's plane of the y-appended state, so that the corner
    line rides along;
  * the CG dot weights the duplicated points by the outer product of the
    x and y weights (:func:`~.sharding.make_sharded_dot`).

Levels with fewer cells than max(sx, sy) are replicated, n_replicated =
max(ceil log2 sx, ceil log2 sy) of them, entered through
:class:`Gather2DTransfer`.  Variants: ``"kron"`` (the JAX class's default)
and ``"sumfac"`` run the plain operator on every pencil, in ``dim`` 2 and
3; ``"auto"`` (the JAX package's ``"pallas"``) runs the kernel path on
every eligible level: B.1's pencil instance (:class:`ShardedCuda2DLaplace`)
and, where a pencil holds two cells on each sharded axis, B.2's pencil
pair (:class:`ShardedFused2DChebyshev`; ``PMG_CHEB2=0`` drops it for plain
Chebyshev on the pencil operator), all in float32; other levels run
``kron``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os

import numpy as np
import torch

from ..fem.assemble import assemble_rhs, l2_norm
from ..fem.basis import h_prolongation_matrix_1d
from ..fem.mesh import HyperCubeMesh
from ..fem.space import FESpace
from ..ops.cuda_cheb2 import make_cheb2_pencil
from ..ops.cuda_laplace import (
    cuda_laplace_pencil_from_factors,
    make_cuda_laplace,
    to_bands,
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
from ..solvers.chebyshev import Chebyshev, _pseudo_random_grid, np_dtype
from ..solvers.vcycle import MGLevel, VCycle
from ..utils.tensors import to_tensor
from .poisson import VARIANTS, _bounds, _partial_assembled_1d, default_devices
from .sharding import (
    Replicated,
    ShardedField,
    ShardedLaplaceOperator,
    ShardedTransfer,
    _shared,
    _thin,
    _to,
    device_groups,
    dot_weights_axis0,
    halo_sum_2d,
    make_sharded_dot,
    partition_axis0,
    per_device,
    slab_bounds,
)

# --------------------------------------------------------------------------
# host-side partitioning
# --------------------------------------------------------------------------


def partition_2d(arr, n: int, p: int, sx: int, sy: int) -> np.ndarray:
    """[N, N, ...] grid -> [sx, sy, Nx_loc, Ny_loc, ...] pencils, the
    duplicated boundary planes of both sharded axes included."""
    arr = np.asarray(arr)
    return np.stack([np.stack([arr[b0:b1, c0:c1]
                               for c0, c1 in slab_bounds(n, p, sy)])
                     for b0, b1 in slab_bounds(n, p, sx)])


def unpartition_2d(st, n: int, p: int, sx: int, sy: int) -> np.ndarray:
    """Invert :func:`partition_2d` (each duplicated plane taken from its
    lower neighbour); ``st`` indexable as st[i][j]."""
    rows = []
    for i in range(sx):
        row = np.concatenate([np.asarray(st[i][j])[:, :-1]
                              for j in range(sy - 1)]
                             + [np.asarray(st[i][sy - 1])], axis=1)
        rows.append(row[:-1] if i < sx - 1 else row)
    return np.concatenate(rows, axis=0)


def shard_2d(arr, n: int, p: int, mesh: tuple, devices, dtype) -> ShardedField:
    """A global grid array (NumPy) as a pencil-sharded field on
    ``devices``, row-major over the (sx, sy) ``mesh``."""
    sx, sy = mesh
    st = partition_2d(arr, n, p, sx, sy)
    return ShardedField(torch.as_tensor(st[s // sy, s % sy], dtype=dtype,
                                        device=dev)
                        for s, dev in enumerate(devices[: sx * sy]))


def dot_weights_2d(n: int, p: int, sx: int, sy: int) -> np.ndarray:
    """[sx, sy, Nx_loc, Ny_loc] reduction weights: the outer product of
    the x and y weights (1/2 on a duplicated plane, 1/4 on a line shared
    by four pencils)."""
    return np.einsum("ia,jb->ijab", dot_weights_axis0(n, p, sx),
                     dot_weights_axis0(n, p, sy))


# --------------------------------------------------------------------------
# plain pencil levels
# --------------------------------------------------------------------------


def _pencil_factors(v, n: int, p: int, sx: int, sy: int, dim: int):
    """Per shard (i, j) the per-axis factors of a global 1D factor ``v``:
    its slice of pencil i along x, of pencil j along y, ``v`` whole on the
    other axes."""
    vx, vy = partition_axis0(v, n, p, sx), partition_axis0(v, n, p, sy)
    return [(vx[s // sy], vy[s % sy]) + (v,) * (dim - 2)
            for s in range(sx * sy)]


def _build_pencil_operator(space: FESpace, mesh: tuple, devices, dtype,
                           variant: str) -> ShardedLaplaceOperator:
    """The plain operator on each pencil (``Sharded2DLaplace``): the
    pencil's x and y extents, its slices of the global mask and diagonal
    factors on both sharded axes, the global factors of the others;
    ``kron`` with the pencil-partial x and y matrices."""
    sx, sy = mesh
    b, dim = space.basis, space.dim
    n, p = space.mesh.cells_per_axis, space.degree
    m1 = space.free_mask_1d()
    gK, gM = diagonal_1d_factors(space)
    facs = [_pencil_factors(v, n, p, sx, sy, dim) for v in (m1, gK, gM)]
    if variant == "kron":
        K1, M1 = assembled_1d_matrices(space)
        parts = (_partial_assembled_1d(space, n // sx),
                 _partial_assembled_1d(space, n // sy))
    local = []
    for s, dev in enumerate(devices[: sx * sy]):
        t = functools.partial(to_tensor, dtype=dtype, device=dev)
        fields = {k: tuple(map(t, f[s]))
                  for k, f in zip(("mask1", "dK1", "dM1"), facs)}
        if variant == "kron":
            fields.update(
                Kg=(t(parts[0][0]), t(parts[1][0])) + (t(K1),) * (dim - 2),
                Mg=(t(parts[0][1]), t(parts[1][1])) + (t(M1),) * (dim - 2))
        else:
            fields.update(B=t(b.B), Dco=t(b.Dco),
                          qmetric=t(quadrature_metric(space)))
        local.append(LaplaceOperator(
            dim=dim, degree=p, n=(n // sx, n // sy) + (n,) * (dim - 2),
            variant=variant, **fields))
    return ShardedLaplaceOperator(local=tuple(local), mesh=(sx, sy))


def _build_pencil_transfer(coarse: FESpace, fine: FESpace, mesh: tuple,
                           devices, dtype) -> ShardedTransfer:
    """The h-transfer on each pencil (``Sharded2DTransfer``): its x and y
    weights and masks the pencil's slices of the global ones."""
    sx, sy = mesh
    p, dim, n_c = coarse.degree, coarse.dim, coarse.mesh.cells_per_axis
    M1 = h_prolongation_matrix_1d(p)
    wf = _weights_1d(n_c, 2 * p) * fine.free_mask_1d()
    wfs = _pencil_factors(wf, 2 * n_c, p, sx, sy, dim)
    mcs = _pencil_factors(coarse.free_mask_1d(), n_c, p, sx, sy, dim)
    local = []
    for s, dev in enumerate(devices[: sx * sy]):
        t = functools.partial(to_tensor, dtype=dtype, device=dev)
        local.append(Transfer(
            dim=dim, n_coarse=(n_c // sx, n_c // sy) + (n_c,) * (dim - 2),
            stride_c=p, stride_f=2 * p, M1=t(M1),
            wmask_f=tuple(map(t, wfs[s])), mask_c1=tuple(map(t, mcs[s]))))
    return ShardedTransfer(local=tuple(local), mesh=(sx, sy))


@dataclasses.dataclass
class Gather2DTransfer:
    """The transfer between the first pencil-sharded level (fine) and the
    replicated level below it (coarse), the JAX package's
    ``Gather2DTransfer``: ``restrict`` gathers the consistent fine pencils
    onto each device once, joins them into the whole fine grid (along x,
    then along y, each duplicated plane once) and restricts there;
    ``prolongate`` prolongates the whole grid once a device and keeps each
    shard's pencil.  ``local``: the plain whole-grid transfer, one per
    device (:func:`~.sharding.per_device`)."""

    local: tuple
    mesh: tuple  # (sx, sy)
    stride: tuple  # fine grid points from one pencil to the next, x and y
    n_points: tuple  # points of a fine pencil, shared ones included

    def _assemble_full(self, f: ShardedField, device) -> torch.Tensor:
        sx, sy = self.mesh
        cols = [torch.cat([_to(f.parts[j], device)]
                          + [_to(f.parts[i * sy + j][1:], device)
                             for i in range(1, sx)]) for j in range(sy)]
        return torch.cat([cols[0]] + [c[:, 1:] for c in cols[1:]], dim=1)

    def restrict(self, f: ShardedField) -> ShardedField:
        done, out = {}, []
        for loc, t in zip(self.local, f.parts):
            if id(loc) not in done:
                done[id(loc)] = loc.restrict(self._assemble_full(f,
                                                                 t.device))
            out.append(done[id(loc)])
        return ShardedField(out)

    def restrict_and_add(self, dst, f):
        return dst + self.restrict(f)

    def prolongate(self, c: ShardedField) -> ShardedField:
        full = _shared(lambda loc, t: loc.prolongate(t),
                       list(zip(self.local, c.parts)))
        sy = self.mesh[1]
        return ShardedField(
            t.narrow(0, s // sy * self.stride[0], self.n_points[0])
            .narrow(1, s % sy * self.stride[1], self.n_points[1])
            for s, t in enumerate(full))

    def prolongate_and_add(self, dst, c):
        return dst + self.prolongate(c)


# --------------------------------------------------------------------------
# the kernel path: B.1's pencil and B.2's pencil pair on every shard
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedCuda2DLaplace:
    """B.1 on a pencil-sharded grid (the JAX package's
    ``ShardedPallas2DLaplace``): each shard runs the pencil instance of the
    kernel (``ops.cuda_laplace.CudaLaplacePencil``) on its x-and-y-full
    input, which writes the raw partial values of its cells with the
    interior pencil boundaries unmasked on x and y; the pencil's last x
    plane (over its whole y extent, the corner line included) and its last
    y row (over x without the last plane), which the kernel drops, are the
    thin completions of :meth:`thin`; one
    :func:`~.sharding.halo_sum_2d` completes the assembly before the
    constraint-mask combine.

    ``thin_x`` / ``thin_y``: per shard (k, m, s), the last row of its
    partial 1D stiffness and mass over its last p+1 planes (rows) with its
    mask on those columns folded in, and the row sum of k; ``bands_x`` /
    ``bands_y``: per shard (mband, kband, ksum) of its masked partial
    assembly over all its planes (rows), the contraction of the other
    in-plane axis of the thin row of y (of x)."""

    mesh: tuple  # (sx, sy)
    local: tuple  # a CudaLaplacePencil per shard
    thin_x: tuple
    thin_y: tuple
    bands_x: tuple
    bands_y: tuple

    @property
    def inv_diag(self) -> ShardedField:
        return ShardedField(loc.inv_diag for loc in self.local)

    @property
    def dtype(self):
        return self.local[0].dtype

    @property
    def degree(self) -> int:
        return self.local[0].degree

    def thin(self, u_in) -> tuple[list, list]:
        """Per shard the raw partial contributions of its cells to its last
        x plane [Ly + 1, N] and to its last y row [Lx, N] of M A M u, from
        its x-and-y-full trimmed input; the shards of one device at once
        (:func:`~.sharding._thin`)."""
        S = len(u_in)
        planes, rows = [None] * S, [None] * S
        for ss in device_groups(u_in):
            loc = self.local[ss[0]]
            p = loc.degree
            zb = loc.mband, loc.kband, loc.ksum

            def stack(field):
                return tuple(torch.stack([field[s][k] for s in ss])
                             for k in range(3))

            lx = _thin(torch.stack([u_in[s][-(p + 1):] for s in ss]),
                       *stack(self.thin_x), zb, stack(self.bands_y))
            ly = _thin(torch.stack([u_in[s][:, -(p + 1):].movedim(1, 0)
                                    for s in ss]),
                       *stack(self.thin_y), zb, stack(self.bands_x))
            for j, s in enumerate(ss):
                planes[s], rows[s] = lx[j], ly[j, :-1]
        return planes, rows

    def apply(self, u: ShardedField) -> ShardedField:
        us = [t.reshape(loc.grid_shape) for loc, t in zip(self.local,
                                                          u.parts)]
        u_in = [t[:, :, :-1].contiguous() for t in us]
        planes, rows = self.thin(u_in)
        out = []
        for loc, t, lx, ly in zip(self.local, u_in, planes, rows):
            au = torch.cat([loc.run("apply", t)[0], ly[:, None]], 1)
            out.append(torch.nn.functional.pad(torch.cat([au, lx[None]]),
                                               (0, 1)))
        out = halo_sum_2d(out, *self.mesh)
        masks = [loc.mask for loc in self.local]
        return ShardedField(m * a + (1.0 - m) * t
                            for m, a, t in zip(masks, out, us))


@dataclasses.dataclass
class ShardedFused2DChebyshev:
    """The pair smoother on pencil-sharded kernel levels (the JAX
    package's ``ShardedFused2DChebyshev``).

    The state is each shard's trimmed points (Lx x Ly x N, duplicate-free).
    Two recurrence steps are one pass of B.2's pencil pair (``op_cheb2``, a
    kernel per shard) on d and r extended by 2p and p planes and rows from
    the neighbours (y first, then x of the y-extended state, so that the
    corner halos arrive too; zeros at the global ends), every output
    exact: the single-device pair's at the same points.  An odd step count
    runs its last step as a zero-coefficient pair (its second step is the
    identity, d2 = 0, x2 = x1), as the JAX module does: the pencil has no
    single-step mode.  ``apply`` starts from the rhs (``cheb2f0``);
    ``smooth`` seeds the recurrence from rhs - A u on the exact pencil
    operator ``op``.  Every stream is in float32 (the JAX package's
    ``sdtype="f32"``).  The public surface takes and returns full pencils,
    so the V-cycle runs on it unchanged."""

    degree: int
    op: ShardedCuda2DLaplace
    op_cheb2: tuple  # a B.2 pencil Cheb2Kernel per shard
    theta: float
    delta: float
    _diag: list | None = dataclasses.field(default=None, init=False,
                                           repr=False, compare=False)

    def _scalars(self):
        dt = np_dtype(self.op.dtype)
        return dt(self.theta), dt(self.delta), dt(1), dt(2)

    def _diag_trimmed(self) -> list:
        """Per shard the diagonal on its trimmed points, made once."""
        if self._diag is None:
            self._diag = [loc.diag_trimmed() for loc in self.op.local]
        return self._diag

    def _trim(self, t: torch.Tensor, s: int) -> torch.Tensor:
        loc = self.op.local[s]
        Lx, Ly, N = loc.trimmed_shape
        return t.reshape(loc.grid_shape)[:Lx, :Ly, :N].contiguous()

    def _ext2(self, ts, h: int) -> list:
        """h rows and h planes of the lower and upper neighbours on both
        sides, y first, then x of the y-extended state (zeros at the
        global ends)."""
        sx, sy = self.op.mesh

        def ext(ts, h, axis, stride, count):
            out = []
            for s, t in enumerate(ts):
                k = s // stride % count
                z = t.new_zeros(t.shape[:axis] + (h,) + t.shape[axis + 1:])
                lo = _to(ts[s - stride].narrow(axis, t.shape[axis] - h, h),
                         t.device) if k else z
                hi = (_to(ts[s + stride].narrow(axis, 0, h), t.device)
                      if k + 1 < count else z)
                out.append(torch.cat([lo, t, hi], axis))
            return out

        return ext(ext(ts, h, 1, 1, sy), h, 0, sy, sx)

    def _to_full(self, xs) -> ShardedField:
        """Trimmed state -> full consistent pencils: the shared row from
        the upper y neighbour, then the shared plane from the upper x
        neighbour's y-appended state (the corner line with it), the
        Dirichlet z plane as zeros."""
        sx, sy = self.op.mesh

        def append(ts, axis, stride, count):
            return [torch.cat([t, _to(ts[s + stride].narrow(axis, 0, 1),
                                      t.device)
                               if s // stride % count + 1 < count
                               else torch.zeros_like(t.narrow(axis, 0, 1))],
                              axis)
                    for s, t in enumerate(ts)]

        return ShardedField(torch.nn.functional.pad(t, (0, 1)) for t in
                            append(append(xs, 1, 1, sy), 0, sy, sx))

    def _pair(self, d, r, x, scal, mode: str) -> list:
        p = self.op.degree
        return [k2.steps2(de, re, xs, scal, mode)
                for k2, de, re, xs in zip(self.op_cheb2,
                                          self._ext2(d, 2 * p),
                                          self._ext2(r, p), x)]

    def _steps(self, r, d, x, k0: int = 0, rho=None) -> list:
        theta, delta, one, two = self._scalars()
        sigma1 = theta / delta
        if rho is None:
            rho = one / sigma1
        n = self.degree - 1
        k = k0
        while k < n:
            rho1 = one / (two * sigma1 - rho)
            if k + 1 == n:
                # the odd tail: one step as a zero-coefficient pair
                scal = (float(rho1 * rho), float(two * rho1 / delta), 0.0,
                        0.0)
                return [o[0] for o in self._pair(d, r, x, scal, "cheb2l")]
            rho2 = one / (two * sigma1 - rho1)
            scal = tuple(map(float, (rho1 * rho, two * rho1 / delta,
                                     rho2 * rho1, two * rho2 / delta)))
            last = k + 2 == n
            outs = self._pair(d, r, x, scal, "cheb2l" if last else "cheb2")
            if last:
                return [o[0] for o in outs]
            r, d, x = map(list, zip(*outs))
            rho = rho2
            k += 2
        return x

    def apply(self, b: ShardedField) -> ShardedField:
        """The preconditioner vmult with x0 = 0 on masked full pencils; the
        entry pair starts from the rhs (``cheb2f0``)."""
        bt = [self._trim(t, s) for s, t in enumerate(b.parts)]
        theta, delta, one, two = self._scalars()
        n = self.degree - 1
        if n >= 2:
            sigma1 = theta / delta
            rho = one / sigma1
            rho1 = one / (two * sigma1 - rho)
            rho2 = one / (two * sigma1 - rho1)
            scal = tuple(map(float, (rho1 * rho, two * rho1 / delta,
                                     rho2 * rho1, two * rho2 / delta,
                                     theta)))
            mode = "cheb2f0l" if n == 2 else "cheb2f0"
            p = self.op.degree
            outs = [k2.steps2(be, None, None, scal, mode)
                    for k2, be in zip(self.op_cheb2,
                                      self._ext2(bt, 2 * p))]
            if n == 2:
                return self._to_full([o[0] for o in outs])
            r, d, x = map(list, zip(*outs))
            return self._to_full(self._steps(r, d, x, k0=2, rho=rho2))
        d0 = [t / (float(theta) * dg)
              for t, dg in zip(bt, self._diag_trimmed())]
        return self._to_full(self._steps(bt, d0, d0))

    def smooth(self, u: ShardedField, rhs: ShardedField) -> ShardedField:
        """u + Cheb(rhs - A u), the residual on the exact operator."""
        theta = float(self._scalars()[0])
        res = rhs - self.op.apply(u)
        r0 = [self._trim(t, s) for s, t in enumerate(res.parts)]
        d0 = [t / (theta * dg) for t, dg in zip(r0, self._diag_trimmed())]
        x0 = [self._trim(t, s) + dd for s, (t, dd) in enumerate(zip(u.parts,
                                                                  d0))]
        return self._to_full(self._steps(r0, d0, x0))


def pencil_eligible(space: FESpace, mesh: tuple, dtype) -> bool:
    """Whether a level runs B.1's pencil instance: 3D, float32 (as the JAX
    package builds its pencil kernels), a whole number of cells per pencil
    on both sharded axes.  The TPU kernel's lane, padding, block and
    8-row conditions (mesh2d.py:232-252) are not the port's: its kernels
    take any extent."""
    n = space.mesh.cells_per_axis
    return (space.dim == 3 and dtype == torch.float32
            and n % mesh[0] == 0 and n % mesh[1] == 0)


def _full_bands(m, K, M, degree: int) -> tuple:
    """(mband, kband, ksum) of a masked partial assembly over all its
    rows: the thin rows' contraction along the other in-plane axis."""
    return (to_bands(m[:, None] * M * m[None, :], degree),
            to_bands(m[:, None] * K * m[None, :], degree),
            -m * (K @ (1.0 - m)))


def _build_pencil_kernel(space: FESpace, mesh: tuple, devices, dtype,
                         sliced=None) -> ShardedCuda2DLaplace | None:
    """B.1's pencil instance on each shard, or None where the level is not
    eligible: the x and y factors the shard's slices of the global mask
    and diagonal factors and the pencil-partial 1D assemblies; the thin
    rows and their bands from the same.  ``sliced``: per shard the
    (mask, dK, dM) slices of x and of y to take instead (the JAX level's,
    ``convert.pencil_levels``)."""
    if not pencil_eligible(space, mesh, dtype):
        return None
    sx, sy = mesh
    n, p = space.mesh.cells_per_axis, space.degree
    K1, M1 = assembled_1d_matrices(space)
    m1 = space.free_mask_1d()
    gK, gM = diagonal_1d_factors(space)
    Kx, Mx = _partial_assembled_1d(space, n // sx)
    Ky, My = _partial_assembled_1d(space, n // sy)
    facs = [_pencil_factors(v, n, p, sx, sy, 3) for v in (m1, gK, gM)]
    local, thin, bands = [], ([], []), ([], [])
    for s, dev in enumerate(devices[: sx * sy]):
        t = functools.partial(to_tensor, dtype=dtype, device=dev)
        (mx, dkx, dmx), (my, dky, dmy) = (
            [tuple(f[s][k] for f in facs) for k in (0, 1)] if sliced is None
            else sliced[s])
        local.append(cuda_laplace_pencil_from_factors(
            p, n, (n // sx, n // sy), m1, K1, M1, gK, gM,
            (mx, Kx, Mx, dkx, dmx), (my, Ky, My, dky, dmy), dtype, dev))
        for k, (m, K, M) in enumerate(((mx, Kx, Mx), (my, Ky, My))):
            m = np.asarray(m, np.float64)
            cols = m[-(p + 1):]
            row_k = K[-1, -(p + 1):]
            # the row sum from the cut columns: a row of K sums to zero
            thin[k].append((t(row_k * cols), t(M[-1, -(p + 1):] * cols),
                            t(-np.dot(row_k, 1.0 - cols))))
            bands[k].append(tuple(map(t, _full_bands(m, K, M, p))))
    return ShardedCuda2DLaplace(mesh=(sx, sy), local=tuple(local),
                                thin_x=tuple(thin[0]), thin_y=tuple(thin[1]),
                                bands_x=tuple(bands[0]),
                                bands_y=tuple(bands[1]))


def _build_pencil_cheb2(space: FESpace, mesh: tuple, devices,
                        dtype) -> tuple | None:
    """B.2's pencil pair on each shard (the JAX package's
    ``_build_stacked_cheb2_2d``), made from the global ``"mxu"`` operator
    on the shard's device (the production grade: the JAX package's
    ``make_cheb2(..., exact=False)``), or None: a level not
    eligible for the pencil, or pencils of one cell along x or y, whose 2p
    planes of halo would reach past the neighbour."""
    if not pencil_eligible(space, mesh, dtype):
        return None
    sx, sy = mesh
    n, p = space.mesh.cells_per_axis, space.degree
    if n // sx < 2 or n // sy < 2:
        return None
    ops = per_device(lambda dev: make_cuda_laplace(space, dtype, dev,
                                                   core="mxu"),
                     devices[: sx * sy])
    Lx, Ly = n // sx * p, n // sy * p
    return tuple(make_cheb2_pencil(op, s // sy * Lx, Lx, s % sy * Ly, Ly)
                 for s, op in enumerate(ops))


# --------------------------------------------------------------------------
# the solve
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Sharded2DStats:
    iterations: int
    residual_norm: float
    converged: bool
    solution_l2_norm: float
    n_dofs: int
    mesh_shape: tuple


class Sharded2DGeometricPoisson:
    """h-multigrid Poisson solve on (sx, sy) pencils over a list of
    devices (every CUDA card by default; a device may repeat,
    ``[torch.device("cpu")] * (sx * sy)`` runs the pencils on the CPU), in
    ``dim`` 2 or 3."""

    def __init__(self, dim: int, degree: int, refinements: int,
                 mesh_shape: tuple, devices=None, dtype=torch.float64,
                 variant: str = "kron"):
        if dim < 2:
            raise ValueError("2D pencil sharding needs dim >= 2")
        sx, sy = mesh_shape
        devices = default_devices() if devices is None else devices
        if len(devices) < sx * sy:
            raise ValueError("not enough devices for the mesh shape")
        if variant not in VARIANTS:
            raise ValueError(f"unknown sharded variant {variant!r}; the port "
                             f"has {VARIANTS} ('auto': the JAX package's "
                             f"'pallas')")
        self.devices = [torch.device(d) for d in devices[: sx * sy]]
        self.mesh = (sx, sy)
        self.dtype, self.dim, self.degree = dtype, dim, degree
        self.variant = variant
        min_ref = max(int(math.ceil(math.log2(max(sx, 1)))),
                      int(math.ceil(math.log2(max(sy, 1)))))
        if refinements < min_ref:
            raise ValueError(f"need >= {min_ref} refinements")
        self.n_replicated = min_ref
        self.spaces = [FESpace(HyperCubeMesh(dim, r), degree)
                       for r in range(refinements + 1)]
        self.levels = tuple(self._build_level(i, sp)
                            for i, sp in enumerate(self.spaces))
        fine = self.spaces[-1]
        w = dot_weights_2d(fine.mesh.cells_per_axis, degree, sx, sy)
        self.dot = make_sharded_dot(
            [torch.as_tensor(w[s // sy, s % sy], dtype=dtype, device=dev)
             for s, dev in enumerate(self.devices)], dim)

    def _build_level(self, i: int, sp: FESpace) -> MGLevel:
        """The level's operator, smoother and transfer, as the JAX
        package's ``_build_level`` chooses them: the eigenvalue bounds from
        a single-device twin on the first device (the level's own plain
        operator where replicated, ``kron`` on a kernel level, ``sumfac``
        on a plain pencil level; Jacobi-preconditioned on each), range 15
        and degree 5 for a smoother, 1e-3 and an adaptive degree for the
        coarse solver."""
        dtype, devices, mesh = self.dtype, self.devices, self.mesh
        n, p = sp.mesh.cells_per_axis, sp.degree
        coarse, R = i == 0, self.n_replicated
        plain = "kron" if self.variant == "auto" else self.variant
        v0 = _pseudo_random_grid(sp.grid_shape) * sp.free_mask()
        cheb2 = None
        if i < R:
            op = Replicated(per_device(
                lambda dev: make_laplace(sp, dtype, plain, dev), devices))
            twin, n_iter = op.local[0], min(sp.n_dofs, 128) if coarse else 10
        else:
            op = None
            if self.variant == "auto":
                op = _build_pencil_kernel(sp, mesh, devices, dtype)
            if op is not None:
                twin = make_laplace(sp, dtype, "kron", devices[0])
                n_iter = sp.n_dofs if coarse else 10
                if not coarse and os.environ.get("PMG_CHEB2", "1") == "1":
                    cheb2 = _build_pencil_cheb2(sp, mesh, devices, dtype)
            else:
                op = _build_pencil_operator(sp, mesh, devices, dtype, plain)
                twin = make_laplace(sp, dtype, "sumfac", devices[0])
                n_iter = min(sp.n_dofs, 128) if coarse else 10
        theta, delta, deg = _bounds(
            twin, coarse, n_iter, dtype,
            torch.as_tensor(v0, dtype=dtype, device=twin.device))
        del twin
        if cheb2 is not None and deg is not None and deg >= 2:
            smoother = ShardedFused2DChebyshev(degree=deg, op=op,
                                               op_cheb2=cheb2, theta=theta,
                                               delta=delta)
        else:
            smoother = Chebyshev(degree=deg, op=op, theta=theta, delta=delta)
        return MGLevel(op=op, smoother=smoother,
                       transfer=self._build_transfer(i, sp))

    def _build_transfer(self, i: int, sp: FESpace):
        if i == 0:
            return None
        prev, R = self.spaces[i - 1], self.n_replicated

        def whole(dev):
            return make_h_transfer(prev, sp, self.dtype, dev)

        if i < R:
            return Replicated(per_device(whole, self.devices))
        if i == R:
            sx, sy = self.mesh
            n, p = sp.mesh.cells_per_axis, sp.degree
            return Gather2DTransfer(
                local=per_device(whole, self.devices), mesh=self.mesh,
                stride=(n // sx * p, n // sy * p),
                n_points=(n // sx * p + 1, n // sy * p + 1))
        return _build_pencil_transfer(prev, sp, self.mesh, self.devices,
                                      self.dtype)

    @property
    def fine_operator(self):
        """The operator CG runs on."""
        return self.levels[-1].op

    def preconditioner(self, pre_smoothing_steps: int = 2,
                       post_smoothing_steps: int = 2) -> VCycle:
        """The V-cycle on pencil-sharded fields, run eagerly."""
        return VCycle(levels=self.levels,
                      pre_smoothing_steps=pre_smoothing_steps,
                      post_smoothing_steps=post_smoothing_steps)

    def rhs(self) -> ShardedField:
        """The load vector of f ≡ 1 as a pencil-sharded field."""
        fine = self.spaces[-1]
        return shard_2d(assemble_rhs(fine), fine.mesh.cells_per_axis,
                        fine.degree, self.mesh, self.devices, self.dtype)

    def gather(self, x: ShardedField) -> np.ndarray:
        """A pencil-sharded fine-level field as one global NumPy array."""
        fine = self.spaces[-1]
        sx, sy = self.mesh
        parts = [t.detach().cpu().numpy() for t in x.parts]
        return unpartition_2d([parts[i * sy: (i + 1) * sy]
                               for i in range(sx)],
                              fine.mesh.cells_per_axis, fine.degree, sx, sy)

    def solve(self, rtol: float = 1e-12, verbose: bool = False):
        """CG with the pencil-sharded V-cycle; returns the global solution
        (NumPy, in the solve's dtype) and :class:`Sharded2DStats`."""
        fine = self.spaces[-1]
        res = cg(self.fine_operator.apply, self.rhs(),
                 self.preconditioner().apply, rtol=rtol, dot=self.dot)
        x = self.gather(res.x)
        sx, sy = self.mesh
        stats = Sharded2DStats(
            iterations=res.iterations, residual_norm=res.residual_norm,
            converged=res.converged,
            solution_l2_norm=l2_norm(fine, x.astype(np.float64)),
            n_dofs=fine.n_dofs, mesh_shape=(sx, sy))
        if verbose:
            print(f" {stats.n_dofs} DoFs over a {sx}x{sy} device mesh; "
                  f"converged in {stats.iterations} iterations; "
                  f"norm {stats.solution_l2_norm:.6g}")
        return x, stats
