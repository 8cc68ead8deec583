"""Slab sharding: the sharded field, halo plane exchange, and the sharded
operator, transfer and smoother wrappers.

Counterpart of ``portable_multigrid_tpu/parallel/sharding.py``.  The DoF
grid is cut into cell slabs along grid axis 0, one slab per shard, with
the single shared DoF plane between neighbouring slabs stored duplicated
and consistent on both (the reference's MPI decomposition, deal.II's
ghosted vectors; reference:
include/operators/portable_laplace_operator.h:635-657,713).  Then:

  * elementwise work (masks, Chebyshev recurrences, axpys) needs no
    exchange: the duplicates stay consistent by construction;
  * every scatter-producing operation (operator apply, prolongation,
    restriction) is the shard-local structured one followed by one
    exchange of boundary planes (:func:`halo_sum`);
  * inner products weight the duplicated planes by 1/2 and sum over the
    shards on the first shard's device (:func:`make_sharded_dot`).

Where the JAX package runs one ``shard_map`` program over a device mesh,
the port runs one controller over an explicit list of devices: a shard's
tensors live on its device, the exchanges copy single planes between
devices (``non_blocking`` where they differ), and a device may repeat, so
that S shards run on one card (or on the CPU in the tests).  A sharded
field is a :class:`ShardedField`, one tensor per shard; it supports the
arithmetic that CG, the V-cycle and the plain Chebyshev smoother use, so
those run on it unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from ..ops.cuda_laplace import diag_trimmed
from ..ops.elasticity import elasticity_chains
from ..solvers.chebyshev import np_dtype


def _windowed(u: torch.Tensor, axis: int, mband: torch.Tensor,
              kband: torch.Tensor | None = None,
              ksum: torch.Tensor | None = None) -> tuple:
    """(M u, K u) along ``axis`` from the bands of M and K (K u None
    without ``kband``), zero beyond the grid, K in difference form,
    sum_o K[i, i+o] (u[i+o] - u[i]) + ksum[i] u[i]: the contractions of
    ``ops.cuda_laplace.banded`` over one set of unfolded windows, a few
    launches in place of a few per tap.  The bands [2p+1, L] and sums [L]
    serve every entry of u, or, as [G, 2p+1, L] and [G, L], each of the G
    entries of u's leading axis its own."""
    p = (mband.shape[-2] - 1) // 2
    t = u.movedim(axis, -1)
    win = torch.nn.functional.pad(t, (p, p)).unfold(-1, 2 * p + 1, 1)

    def per(v):  # [G, ...] against the windows (or against t: sums)
        return v.reshape(v.shape[:1] + (1,) * (t.ndim - 2)
                         + v.shape[1:]) if mband.ndim == 3 else v

    mu = (win * per(mband.transpose(-1, -2))).sum(-1).movedim(-1, axis)
    if kband is None:
        return mu, None
    ku = ((win - t[..., None]) * per(kband.transpose(-1, -2))).sum(-1) \
        + per(ksum) * t
    return mu, ku.movedim(-1, axis)


def _thin(w: torch.Tensor, kt, mt, st, zb: tuple, ob: tuple) -> torch.Tensor:
    """The raw partial contribution of a shard's cells to the last row
    along its thin axis, which B.1's slab and pencil drop, from ``w``
    [G, p+1, A, Z]: the last p+1 rows along the thin axis of G shards'
    inputs.  The thin row goes first: w_K = sum_j k_j (w_j - w_p) + s w_p
    (K in difference form, s its row sum) and w_M = sum_j m_j w_j, with
    ``kt``, ``mt`` [G, p+1] and ``st`` [G]; then z and the other in-plane
    axis A as the kernel contracts them, on those two rows: Mo Mz w_K +
    (Ko Mz + Mo Kz) w_M, ``zb`` and ``ob`` the (mband, kband, ksum) of z
    and of A (those of A per shard or shared, :func:`_windowed`)."""
    c = w[:, -1]
    wk = (torch.einsum("gk,gkyz->gyz", kt, w - c[:, None])
          + st[:, None, None] * c)
    wm = torch.einsum("gk,gkyz->gyz", mt, w)
    mz, kz = _windowed(torch.stack([wk, wm], 1), 3, *zb)
    my, ky = _windowed(torch.stack([mz[:, 0], mz[:, 1], kz[:, 1]], 1), 2,
                       *ob)
    return my[:, 0] + ky[:, 1] + my[:, 2]


def _thin_vector(w: torch.Tensor, rows: torch.Tensor, sums: torch.Tensor,
                 bands: torch.Tensor, bsums: torch.Tensor,
                 weights: torch.Tensor) -> torch.Tensor:
    """The raw partial contribution of a shard's cells to the last x plane
    of the elasticity operator, which B.5's slab drops, from ``w`` [G, 3,
    p+1, N, N]: the last p+1 planes of G shards' x-full inputs (the vector
    form of :func:`_thin`), in a few launches.  K, G and H run in
    difference form, sum_j W_j (w_j - w_i) + s_i w_i, M directly.  The x
    row goes first, per component, from ``rows`` [G, 4, p+1] (K, M, G, H)
    and ``sums`` [G, 4] (M's unused); then every z matrix on every such
    plane, from ``bands`` [4, N, 2p+1] (the global mask-folded bands of K,
    M, G and H, transposed; y and z share them) and ``bsums`` [4, N]; the
    chains' ``weights`` [3, 4, 4, 4, 3] (input, x, z and y matrix, output)
    sum the y-z products by y matrix and output, and each sum takes its
    y matrix."""
    p = (bands.shape[-1] - 1) // 2
    c = w[:, :, -1:]
    wx = (torch.einsum("gxk,gakyz->gaxyz", rows, w - c)
          + sums[:, None, :, None, None] * c)
    wx[:, :, 1] = torch.einsum("gk,gakyz->gayz", rows[:, 1], w)
    win = torch.nn.functional.pad(wx, (p, p)).unfold(-1, 2 * p + 1, 1)
    wz = (torch.einsum("gaxyzo,mzo->gaxmyz", win - wx[..., None], bands)
          + bsums[:, None, :] * wx[:, :, :, None])
    wz[:, :, :, 1] = torch.einsum("gaxyzo,zo->gaxyz", win, bands[1])
    v = torch.einsum("gaxmyz,axmnc->gnczy", wz, weights)
    win = torch.nn.functional.pad(v, (p, p)).unfold(-1, 2 * p + 1, 1)
    wy = (torch.einsum("gnczyo,nyo->gnczy", win - v[..., None], bands)
          + bsums[None, :, None, None, :] * v)
    wy[:, 1] = torch.einsum("gczyo,yo->gczy", win[:, 1], bands[1])
    return wy.sum(1).transpose(-1, -2)


# --------------------------------------------------------------------------
# the sharded field
# --------------------------------------------------------------------------


def _to(t, device):
    """A tensor scalar on ``device`` (a Python number as it is)."""
    if isinstance(t, torch.Tensor) and t.device != device:
        return t.to(device, non_blocking=True)
    return t


def _shared(fn, args: list) -> list:
    """fn(*a) for each tuple a of ``args``, computed once for tuples of
    the same objects."""
    done = {}
    return [done[k] if k in done else done.setdefault(k, fn(*a))
            for a in args for k in [tuple(map(id, a))]]


class ShardedField:
    """One tensor per shard, each on its shard's device: ``+``, ``-``,
    multiplication and division by a scalar (a number or a tensor, moved to
    each shard's device) or by a field, ``clone``, ``torch.zeros_like`` and
    ``numel`` (the shards' total).  Shards that hold the same tensor (a
    replicated level's shards on one device, :class:`Replicated`) share
    the result of every operation, computed once."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = tuple(parts)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func is torch.zeros_like and not kwargs:
            return args[0].map(torch.zeros_like)
        return NotImplemented

    def map(self, fn) -> "ShardedField":
        return ShardedField(_shared(fn, [(t,) for t in self.parts]))

    def _zip(self, other, fn) -> "ShardedField":
        if isinstance(other, ShardedField):
            return ShardedField(_shared(fn, list(zip(self.parts,
                                                     other.parts))))
        moved = {}
        return ShardedField(_shared(fn, [
            (a, moved.setdefault(a.device, _to(other, a.device)))
            for a in self.parts]))

    def __add__(self, other):
        return self._zip(other, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, other):
        return self._zip(other, lambda a, b: a - b)

    def __mul__(self, other):
        return self._zip(other, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._zip(other, lambda a, b: a / b)

    def clone(self) -> "ShardedField":
        return self.map(torch.clone)

    def numel(self) -> int:
        return sum(t.numel() for t in self.parts)

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self):
        return self.parts[0].device


def device_groups(parts) -> list:
    """The indices of the shards on each device, in order."""
    groups = {}
    for s, t in enumerate(parts):
        groups.setdefault(t.device, []).append(s)
    return list(groups.values())


def halo_sum(parts, axis: int = 0) -> list:
    """Sum the duplicated boundary planes of neighbouring shards, in place:
    plane 0 of shard s gains the last plane of shard s - 1, and its last
    plane the first of shard s + 1 (the shards at the ends have no such
    neighbour).  ``axis``: the sharded grid axis (1 for a field with a
    leading component axis).  Every plane is copied before any is added."""
    parts = list(parts)
    S = len(parts)
    if S == 1:
        return parts
    ends = [(t.narrow(axis, 0, 1), t.narrow(axis, t.shape[axis] - 1, 1))
            for t in parts]
    from_left = [None] + [ends[s - 1][1].to(parts[s].device, copy=True,
                                            non_blocking=True)
                          for s in range(1, S)]
    from_right = [ends[s + 1][0].to(parts[s].device, copy=True,
                                    non_blocking=True)
                  for s in range(S - 1)] + [None]
    for s in range(S):
        if from_left[s] is not None:
            ends[s][0].add_(from_left[s])
        if from_right[s] is not None:
            ends[s][1].add_(from_right[s])
    return parts


def halo_sum_2d(parts, sx: int, sy: int) -> list:
    """:func:`halo_sum` on a pencil-sharded field, shards in row-major
    order over the (sx, sy) mesh (shard (i, j) at i sy + j): along x in
    each x group (fixed j), then along y in each y group (fixed i).  The y
    exchange carries the x-completed planes, so that the points shared by
    four shards gather all four contributions."""
    parts = list(parts)
    for j in range(sy):
        halo_sum([parts[i * sy + j] for i in range(sx)], 0)
    for i in range(sx):
        halo_sum(parts[i * sy: (i + 1) * sy], 1)
    return parts


def exchange(parts, mesh: tuple | None, axis: int = 0) -> list:
    """The halo exchange of a slab-sharded field (``mesh`` None: along
    ``axis``) or of a pencil-sharded one over the (sx, sy) ``mesh``."""
    return halo_sum(parts, axis) if mesh is None else halo_sum_2d(parts,
                                                                  *mesh)


def make_sharded_dot(weights, dim: int, lead_axes: int = 0):
    """The duplicate-plane-weighted inner product of two fields, summed
    over the shards on the first shard's device.  ``weights``: per shard
    the weights of its points along its sharded axes, [N_loc] on a slab
    (0.5 on a plane duplicated with a neighbour, 1 elsewhere) or
    [Nx_loc, Ny_loc] on a pencil (the outer product of the x and y
    weights); ``lead_axes`` leading (component) axes precede the grid."""
    ws = [w.reshape((1,) * lead_axes + tuple(w.shape)
                    + (1,) * (dim - w.ndim)) for w in weights]

    def dot(a: ShardedField, b: ShardedField) -> torch.Tensor:
        home = a.parts[0].device
        total = None
        for w, x, y in zip(ws, a.parts, b.parts):
            v = _to(torch.dot((x * w).reshape(-1), y.reshape(-1)), home)
            total = v if total is None else total + v
        return total

    return dot


# --------------------------------------------------------------------------
# plain sharded wrappers
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedLaplaceOperator:
    """The Laplace operator on a slab-sharded grid: each shard's local
    operator (``ops/laplace.py``, its x extent the slab's), then
    :func:`halo_sum`, then the constraint-mask combine, which runs after the
    exchange (the masks agree on duplicated planes), so that A_eff =
    M A M + (I - M) holds globally."""

    local: tuple  # a LaplaceOperator per shard
    mesh: tuple | None = None  # (sx, sy) of a pencil-sharded grid
    halo_axis: ClassVar[int] = 0  # the sharded grid axis of a field

    @property
    def inv_diag(self) -> ShardedField:
        return ShardedField(loc.inv_diag for loc in self.local)

    def apply(self, u: ShardedField) -> ShardedField:
        us = [t.reshape(loc.shape) for loc, t in zip(self.local, u.parts)]
        masks = [loc.mask for loc in self.local]
        au = exchange([loc.apply_bilinear(t * m)
                       for loc, t, m in zip(self.local, us, masks)],
                      self.mesh, self.halo_axis)
        return ShardedField(m * a + (1.0 - m) * t
                            for m, a, t in zip(masks, au, us))


@dataclasses.dataclass
class ShardedElasticityOperator(ShardedLaplaceOperator):
    """The elasticity operator on a slab-sharded grid (the JAX package's
    ``ShardedElasticityOperator``): each shard's ``ElasticityOperator``
    (``ops/elasticity.py``, its x extent and x factors the slab's) on the
    masked slab, then :func:`halo_sum` along axis 1 (axis 0 is the
    component axis), then the mask combine, the scalar mask shared by every
    component."""

    halo_axis: ClassVar[int] = 1


@dataclasses.dataclass
class ShardedTransfer:
    """A two-level transfer on slab-sharded grids: each shard's local
    transfer, then :func:`halo_sum`.  Both directions end in an axis-0
    overlap-add whose shard-boundary planes the exchange completes; the
    separable weights and masks commute with it (they agree on duplicated
    planes).  ``halo_axis`` is the sharded grid axis of the fields it moves:
    0 for scalar fields, 1 for component-major vector fields, whose axis 0
    is the component axis (a transfer that exchanged along axis 0 there
    would mix components, the JAX package's fault 1f97bde).

    The shards of one device run as one batch: their slabs stacked on a
    leading axis, their x factors stacked beside it (``batched``), the
    same arithmetic in a few launches instead of a few per shard.  On a
    pencil-sharded grid (``mesh`` = (sx, sy)) the x and the y factors are
    the shard's and the exchange is :func:`halo_sum_2d`."""

    local: tuple  # a Transfer per shard
    halo_axis: int = 0
    mesh: tuple | None = None

    def __post_init__(self):
        self.batched = _batch_transfers(self.local, self.halo_axis,
                                        1 if self.mesh is None else 2)

    def _run(self, name: str, f: ShardedField) -> ShardedField:
        out = [None] * len(self.local)
        for shards, tr in self.batched:
            res = getattr(tr, name)(torch.stack([f.parts[s] for s in shards]))
            for j, s in enumerate(shards):
                out[s] = res[j]
        return ShardedField(exchange(out, self.mesh, self.halo_axis))

    def prolongate(self, c: ShardedField) -> ShardedField:
        return self._run("prolongate", c)

    def prolongate_and_add(self, dst, c):
        return dst + self.prolongate(c)

    def restrict(self, f: ShardedField) -> ShardedField:
        return self._run("restrict", f)

    def restrict_and_add(self, dst, f):
        return dst + self.restrict(f)


def _batch_transfers(local, halo_axis: int, n_sharded: int = 1) -> list:
    """(shards, transfer) per device: one transfer over the device's shards
    stacked on a leading axis, the factors of its first ``n_sharded`` axes
    (x on a slab, x and y on a pencil) the shards' stacked and shaped to
    broadcast against the stack (``ops.laplace.bcast`` passes them
    through), the other axes' factors and the 1D matrix the first
    shard's."""
    out = []
    for shards in device_groups([tr.M1 for tr in local]):
        first = local[shards[0]]

        def stack(factors):
            stacked = []
            for ax in range(n_sharded):
                v = torch.stack([f[ax] for f in factors])
                shape = [1] * first.dim
                shape[ax] = v.shape[1]
                stacked.append(v.reshape((len(shards),) + (1,) * halo_axis
                                         + tuple(shape)))
            return tuple(stacked) + tuple(factors[0][n_sharded:])

        out.append((shards, dataclasses.replace(
            first,
            wmask_f=stack([local[s].wmask_f for s in shards]),
            mask_c1=stack([local[s].mask_c1 for s in shards]))))
    return out


@dataclasses.dataclass
class Replicated:
    """A level below the shard granularity, replicated: each shard holds the
    whole grid and applies a plain operator or transfer to it, the same
    work on the same data, so that every shard holds the same values bit
    for bit.  ``local`` holds one object per device (:func:`per_device`),
    and the shards of one device hold one tensor, so that the work runs
    once for them (:class:`ShardedField`)."""

    local: tuple  # a LaplaceOperator or a Transfer per shard

    def _map(self, name: str, u: ShardedField) -> ShardedField:
        return ShardedField(_shared(lambda loc, t: getattr(loc, name)(t),
                                    list(zip(self.local, u.parts))))

    @property
    def inv_diag(self) -> ShardedField:
        return ShardedField(_shared(lambda loc: loc.inv_diag,
                                    [(loc,) for loc in self.local]))

    def apply(self, u):
        return self._map("apply", u)

    def prolongate(self, c):
        return self._map("prolongate", c)

    def restrict(self, f):
        return self._map("restrict", f)

    def prolongate_and_add(self, dst, c):
        return dst + self.prolongate(c)

    def restrict_and_add(self, dst, f):
        return dst + self.restrict(f)


def per_device(make, devices) -> tuple:
    """make(device) for each shard's device, made once per device and held
    by each of its shards."""
    made = {}
    return tuple(made[d] if d in made else made.setdefault(d, make(d))
                 for d in devices)


@dataclasses.dataclass
class GatherTransfer:
    """The transfer between the first sharded level (fine) and the
    replicated level below it (coarse).

    The reference coarsens to the one-cell mesh whatever the number of
    ranks (reference: source/geometric_multigrid/program.cc:137-147); below
    the shard granularity the levels are replicated.  ``restrict`` gathers
    the consistent fine slabs onto every shard's device, joins them into
    the whole fine grid (each duplicated plane once) and restricts there;
    ``prolongate`` prolongates the whole grid on each shard and keeps the
    shard's slab.  ``local`` is the plain whole-grid transfer, one per
    device (:func:`per_device`), which runs once for the shards of a
    device."""

    local: tuple
    slab_stride: int  # fine grid planes from one shard's slab to the next
    n_loc_points: int  # planes of a fine slab, the shared ones included

    def restrict(self, f: ShardedField) -> ShardedField:
        done, out = {}, []
        for loc, t in zip(self.local, f.parts):
            if id(loc) not in done:
                dev = t.device
                done[id(loc)] = loc.restrict(torch.cat(
                    [_to(f.parts[0], dev)]
                    + [_to(u[1:], dev) for u in f.parts[1:]]))
            out.append(done[id(loc)])
        return ShardedField(out)

    def restrict_and_add(self, dst, f):
        return dst + self.restrict(f)

    def prolongate(self, c: ShardedField) -> ShardedField:
        full = _shared(lambda loc, t: loc.prolongate(t),
                       list(zip(self.local, c.parts)))
        return ShardedField(t.narrow(0, s * self.slab_stride,
                                     self.n_loc_points)
                            for s, t in enumerate(full))

    def prolongate_and_add(self, dst, c):
        return dst + self.prolongate(c)


# --------------------------------------------------------------------------
# the kernel path: B.1's slab and B.2's xext pair on every shard
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ShardedCudaLaplace:
    """B.1 on a slab-sharded grid (the JAX package's
    ``ShardedPallasLaplace``): each shard runs the slab instance of the
    kernel (``ops.cuda_laplace.CudaLaplaceSlab``) on its x-full state, which
    writes the raw partial planes of its cells with the interior shard
    boundaries unmasked; the slab's last plane, which the kernel drops, is
    the thin completion :meth:`thin` (plain torch, over the last p+1 input
    planes); one :func:`halo_sum` completes the assembly before the
    constraint-mask combine.

    ``thin_kx`` / ``thin_mx``: per shard the last row of the slab-partial
    1D stiffness / mass over its last p+1 planes, with the shard's x mask
    on those columns folded in; ``thin_sx`` the sum of ``thin_kx``, taken
    on the host as :func:`~..ops.cuda_laplace.row_sums` takes K's, for the
    difference form."""

    local: tuple  # a CudaLaplaceSlab per shard
    thin_kx: tuple
    thin_mx: tuple
    thin_sx: tuple

    @property
    def inv_diag(self) -> ShardedField:
        return ShardedField(loc.inv_diag for loc in self.local)

    @property
    def dtype(self):
        return self.local[0].dtype

    @property
    def degree(self) -> int:
        return self.local[0].degree

    def thin(self, u_ext) -> list:
        """Per shard the raw partial contribution of its cells to plane L
        of M A M u, the row its kernel drops, from its x-full trimmed
        input; the shards of one device at once.  The x row goes first,
        on the last p+1 planes: w_K = sum_j Kx_j (u_j - u_L) + s u_L (K in
        difference form, s its row sum) and w_M = sum_j Mx_j u_j; then y
        and z as the kernel contracts them, on those two planes:
        My Mz w_K + (Ky Mz + My Kz) w_M."""
        out = [None] * len(u_ext)
        for ss in device_groups(u_ext):
            loc = self.local[ss[0]]
            p = loc.degree
            zb = loc.mband, loc.kband, loc.ksum
            last = _thin(torch.stack([u_ext[s][-(p + 1):] for s in ss]),
                         *(torch.stack([v[s] for s in ss]) for v in (
                             self.thin_kx, self.thin_mx, self.thin_sx)),
                         zb, zb)
            for j, s in enumerate(ss):
                out[s] = last[j]
        return out

    def apply(self, u: ShardedField) -> ShardedField:
        us = [t.reshape(loc.grid_shape) for loc, t in zip(self.local,
                                                          u.parts)]
        uk = [t[:, :-1, :-1].contiguous() for t in us]
        out = [torch.nn.functional.pad(
                   torch.cat([loc.run("apply", t)[0], last[None]]),
                   (0, 1, 0, 1))
               for loc, t, last in zip(self.local, uk, self.thin(uk))]
        out = halo_sum(out)
        masks = [loc.mask for loc in self.local]
        return ShardedField(m * a + (1.0 - m) * t
                            for m, a, t in zip(masks, out, us))


@dataclasses.dataclass
class ShardedFusedChebyshev:
    """The fused Chebyshev smoother on slab-sharded kernel levels (the JAX
    package's ``ShardedFusedChebyshev``).

    The state is each shard's trimmed planes (duplicate-free: shard s owns
    its L = n_loc p planes from s L; y and z trimmed).  A single recurrence
    step is one pass of B.1's ``chebf`` on ``op_smooth`` (the ``"mxu"``
    core) on x-full d, the shard's planes and its right neighbour's first;
    the only incomplete entries are then plane 0's, which lack the left
    neighbour's cells: its thin completion (:meth:`ShardedCudaLaplace.thin`
    of the exact ``op``), sent right, corrects r, d and x there, exactly,
    because the updates are linear in the residual.  With ``op_cheb2`` (a
    B.2 ``xext`` kernel per shard) two steps are one pass on d and r
    extended by 2p and p planes from both neighbours, every output exact
    (the single-device pair's at the same planes).  ``smooth`` seeds the
    recurrence with ``residual3f`` and ``residual`` is ``residual1f``, both
    on the exact ``op``, each with its plane-0 completion.  Every stream is
    in float32 (the JAX package's ``sdtype="f32"``).

    The public surface takes and returns full slabs (L + 1 planes, y and z
    whole), so the V-cycle runs on it unchanged."""

    degree: int
    op: ShardedCudaLaplace  # the exact core: residuals, thin rows
    op_smooth: ShardedCudaLaplace  # the mxu core: the recurrence
    theta: float
    delta: float
    op_cheb2: tuple | None = None  # a B.2 xext Cheb2Kernel per shard
    _idg0: list | None = dataclasses.field(default=None, init=False,
                                           repr=False, compare=False)

    @property
    def _p(self) -> int:
        return self.op.degree

    def _scalars(self):
        dt = np_dtype(self.op.dtype)
        return dt(self.theta), dt(self.delta), dt(1), dt(2)

    # --- representation and exchange -------------------------------------
    def _trim(self, t: torch.Tensor, s: int) -> torch.Tensor:
        loc = self.op.local[s]
        L, N, _ = loc.trimmed_shape
        return t.reshape(loc.grid_shape)[:L, :N, :N].contiguous()

    def _ext_x(self, t: torch.Tensor, s: int) -> torch.Tensor:
        """The full slab -> the x-full trimmed input (L + 1 planes)."""
        loc = self.op.local[s]
        N = loc.trimmed_shape[1]
        return t.reshape(loc.grid_shape)[:, :N, :N].contiguous()

    @staticmethod
    def _ext_from_right(ts) -> list:
        """Append plane L, the right neighbour's plane 0 (zeros at the last
        shard: the global Dirichlet face)."""
        S = len(ts)
        return [torch.cat([t, _to(ts[s + 1][:1], t.device) if s + 1 < S
                           else torch.zeros_like(t[:1])])
                for s, t in enumerate(ts)]

    @staticmethod
    def _send_right(planes) -> list:
        """Shard s gets shard s - 1's plane (zeros at the first)."""
        return [_to(planes[s - 1], t.device) if s else torch.zeros_like(t)
                for s, t in enumerate(planes)]

    @staticmethod
    def _ext_both(ts, h: int) -> list:
        """Prepend / append h planes of the left / right neighbour (zeros at
        the global ends)."""
        S = len(ts)
        out = []
        for s, t in enumerate(ts):
            z = t.new_zeros((h,) + t.shape[1:])
            left = _to(ts[s - 1][-h:], t.device) if s else z
            right = _to(ts[s + 1][:h], t.device) if s + 1 < S else z
            out.append(torch.cat([left, t, right]))
        return out

    def _to_full(self, xs) -> ShardedField:
        """Trimmed state -> full consistent slabs: the shared plane from
        the right neighbour, the Dirichlet y-z planes as zeros."""
        return ShardedField(torch.nn.functional.pad(t, (0, 1, 0, 1))
                            for t in self._ext_from_right(xs))

    def _fix_row0(self, outs, u_ext, scale) -> list:
        """Correct plane 0 of each shard's (r, d, x) outputs by the left
        neighbour's thin row delta: r -= delta, d and x -= scale_s delta,
        with scale_s the shard's plane-0 factor (or none for r alone)."""
        delta = self._send_right(self.op.thin(u_ext))
        for s, (o, dl) in enumerate(zip(outs, delta)):
            o[0][:1].sub_(dl)
            if len(o) > 1:
                corr = scale[s] * dl
                o[1][:1].sub_(corr)
                o[2][:1].sub_(corr)
        return outs

    def _inv_diag_row0(self) -> list:
        """Per shard 1 / diag on its plane 0 (1, N, N), made once."""
        if self._idg0 is None:
            self._idg0 = [1.0 / diag_trimmed(loc.dKt, loc.dMt, loc.dK1x[:1],
                                             loc.dM1x[:1])
                          for loc in self.op.local]
        return self._idg0

    # --- the smoother -------------------------------------------------------
    def _steps(self, r, d, x, k0: int = 0, rho=None) -> list:
        theta, delta, one, two = self._scalars()
        sigma1 = theta / delta
        if rho is None:
            rho = one / sigma1
        p = self._p
        idg0 = self._inv_diag_row0()
        n = self.degree - 1
        k = k0
        while k < n:
            rho_new = one / (two * sigma1 - rho)
            c1 = two * rho_new / delta
            if self.op_cheb2 is not None and k + 1 < n:
                rho2 = one / (two * sigma1 - rho_new)
                scal = tuple(map(float, (rho_new * rho, c1, rho2 * rho_new,
                                         two * rho2 / delta)))
                last = k + 2 == n
                outs = [k2.steps2(de, re, xs, scal,
                                  "cheb2l" if last else "cheb2")
                        for k2, de, re, xs in zip(
                            self.op_cheb2, self._ext_both(d, 2 * p),
                            self._ext_both(r, p), x)]
                if last:
                    return [o[0] for o in outs]
                r, d, x = map(list, zip(*outs))
                rho = rho2
                k += 2
                continue
            scal = (float(rho_new * rho), float(c1))
            d_ext = self._ext_from_right(d)
            outs = [loc.run("chebf", de, (rs, xs), scal)
                    for loc, de, rs, xs in zip(self.op_smooth.local, d_ext,
                                               r, x)]
            outs = self._fix_row0(outs, d_ext,
                                  [float(c1) * i for i in idg0])
            r, d, x = map(list, zip(*outs))
            rho = rho_new
            k += 1
        return x

    def apply(self, b: ShardedField) -> ShardedField:
        """The preconditioner vmult with x0 = 0 on a masked full slab; with
        the pair kernel the entry pair starts from the rhs (``cheb2f0``)."""
        bt = [self._trim(t, s) for s, t in enumerate(b.parts)]
        theta, delta, one, two = self._scalars()
        n = self.degree - 1
        if self.op_cheb2 is not None and n >= 2:
            sigma1 = theta / delta
            rho = one / sigma1
            rho1 = one / (two * sigma1 - rho)
            rho2 = one / (two * sigma1 - rho1)
            scal = tuple(map(float, (rho1 * rho, two * rho1 / delta,
                                     rho2 * rho1, two * rho2 / delta,
                                     theta)))
            mode = "cheb2f0l" if n == 2 else "cheb2f0"
            outs = [k2.steps2(be, None, None, scal, mode)
                    for k2, be in zip(self.op_cheb2,
                                      self._ext_both(bt, 2 * self._p))]
            if n == 2:
                return self._to_full([o[0] for o in outs])
            r, d, x = map(list, zip(*outs))
            return self._to_full(self._steps(r, d, x, k0=2, rho=rho2))
        d0 = [t / (float(theta) * loc.diag_trimmed())
              for t, loc in zip(bt, self.op.local)]
        return self._to_full(self._steps(bt, d0, d0))

    def smooth(self, u: ShardedField, rhs: ShardedField) -> ShardedField:
        """u + Cheb(rhs - A u): ``residual3f`` seeds the recurrence."""
        theta = float(self._scalars()[0])
        u_ext = [self._ext_x(t, s) for s, t in enumerate(u.parts)]
        outs = [loc.run("residual3f", ue, (self._trim(f, s),), (theta,))
                for s, (loc, ue, f) in enumerate(zip(self.op.local, u_ext,
                                                     rhs.parts))]
        outs = self._fix_row0(outs, u_ext,
                              [i / theta for i in self._inv_diag_row0()])
        return self._to_full(self._steps(*map(list, zip(*outs))))

    def residual(self, u: ShardedField, rhs: ShardedField) -> ShardedField:
        """rhs - A u on the free DoFs: ``residual1f``."""
        u_ext = [self._ext_x(t, s) for s, t in enumerate(u.parts)]
        outs = [loc.run("residual1f", ue, (self._trim(f, s),))
                for s, (loc, ue, f) in enumerate(zip(self.op.local, u_ext,
                                                     rhs.parts))]
        outs = self._fix_row0(outs, u_ext, None)
        return self._to_full([o[0] for o in outs])


@dataclasses.dataclass
class ShardedCudaElasticity:
    """B.5 on a slab-sharded grid (the JAX package's
    ``ShardedPallasElasticity``): each shard runs the slab instance of the
    kernel (``ops.cuda_elasticity.CudaElasticitySlab``) on its x-full
    state, which writes the raw partial planes of its cells for the three
    components with the interior shard boundaries unmasked; the slab's last
    plane, which the kernel drops, is the thin completion :meth:`thin`
    (plain torch over the last p+1 input planes, through all 21 chains, as
    the JAX package computes it outside the kernel); one three-component
    :func:`halo_sum` along axis 1 completes the assembly before the
    constraint-mask combine.

    ``thin_kx``, ``thin_mx``, ``thin_gx``, ``thin_hx``: per shard the last
    row of the slab-partial K, M, G and H = G^T over its last p+1 planes,
    with the shard's x mask on those columns folded in; ``thin_ks``,
    ``thin_gs``, ``thin_hs`` their sums, taken on the host in float64 (the
    last row of G sums to +1 where its columns are free), for the
    difference form.  The shards of one device run :meth:`thin` as one
    batch."""

    local: tuple  # a CudaElasticitySlab per shard
    thin_kx: tuple
    thin_mx: tuple
    thin_gx: tuple
    thin_hx: tuple
    thin_ks: tuple
    thin_gs: tuple
    thin_hs: tuple

    def __post_init__(self):
        """Per device what :func:`_thin_vector` takes besides the planes,
        made once: its shards' thin rows [G, 4, p+1] and sums [G, 4], the
        y-z bands [4, N, 2p+1] and sums [4, N], and the chains' weights."""
        first = self.local[0]
        W = np.zeros((3, 4, 4, 4, 3))
        for c, a, names, w in elasticity_chains(first.mu, first.lam):
            X, Y, Z = ("KMGH".index(m) for m in names)
            W[a, X, Z, Y, c] += w
        self._thin_state = {}
        for ss in device_groups([loc.mask1 for loc in self.local]):
            loc = self.local[ss[0]]

            def stack(v):
                return torch.stack([v[s] for s in ss])

            ks = stack(self.thin_ks)
            self._thin_state[loc.device] = (
                torch.stack([stack(v) for v in (self.thin_kx, self.thin_mx,
                                                self.thin_gx, self.thin_hx)],
                            1),
                torch.stack([ks, torch.zeros_like(ks), stack(self.thin_gs),
                             stack(self.thin_hs)], 1),
                torch.stack([b.T for b in (loc.kband, loc.mband, loc.gband,
                                           loc.hband)]),
                torch.stack([loc.ksum, torch.zeros_like(loc.ksum), loc.gsum,
                             loc.hsum]),
                torch.as_tensor(W, dtype=loc.dtype, device=loc.device))

    @property
    def inv_diag(self) -> ShardedField:
        return ShardedField(loc.inv_diag for loc in self.local)

    @property
    def dtype(self):
        return self.local[0].dtype

    @property
    def degree(self) -> int:
        return self.local[0].degree

    def thin(self, u_ext) -> list:
        """Per shard the raw partial contribution of its cells to plane L of
        M A M u, [3, N, N], the plane its kernel drops, from its x-full
        trimmed input [3, L + 1, N, N]; the shards of one device at once
        (:func:`_thin_vector`)."""
        out = [None] * len(u_ext)
        p = self.degree
        for ss in device_groups(u_ext):
            last = _thin_vector(
                torch.stack([u_ext[s][:, -(p + 1):] for s in ss]),
                *self._thin_state[u_ext[ss[0]].device])
            for j, s in enumerate(ss):
                out[s] = last[j]
        return out

    def apply(self, u: ShardedField) -> ShardedField:
        us = [t.reshape(loc.shape) for loc, t in zip(self.local, u.parts)]
        uk = [t[:, :, :-1, :-1].contiguous() for t in us]
        out = [torch.nn.functional.pad(
                   torch.cat([loc.run("apply", t)[0], last[:, None]], 1),
                   (0, 1, 0, 1))
               for loc, t, last in zip(self.local, uk, self.thin(uk))]
        out = halo_sum(out, 1)
        masks = [loc.mask for loc in self.local]
        return ShardedField(m * a + (1.0 - m) * t
                            for m, a, t in zip(masks, out, us))


# --------------------------------------------------------------------------
# host-side partitioning helpers
# --------------------------------------------------------------------------


def slab_bounds(n_cells: int, degree: int, n_shards: int) -> list:
    """Grid index ranges [start, stop) per shard, the duplicated boundary
    planes included (stop - start = n_loc p + 1)."""
    if n_cells % n_shards != 0:
        raise ValueError(f"cells per axis ({n_cells}) must be divisible by "
                         f"n_shards ({n_shards})")
    n_loc = n_cells // n_shards
    return [(s * n_loc * degree, (s + 1) * n_loc * degree + 1)
            for s in range(n_shards)]


def partition_axis0(arr, n_cells: int, degree: int, n_shards: int):
    """Stack the per-shard slabs of a global grid array: [N, ...] ->
    [S, N_loc, ...], a NumPy array or a tensor as ``arr`` is."""
    bounds = slab_bounds(n_cells, degree, n_shards)
    if isinstance(arr, torch.Tensor):
        return torch.stack([arr[b0:b1] for b0, b1 in bounds])
    return np.stack([np.asarray(arr)[b0:b1] for b0, b1 in bounds])


def unpartition_axis0(stacked, n_cells: int, degree: int, n_shards: int):
    """Invert :func:`partition_axis0` (each duplicated plane taken from its
    left owner); ``stacked`` a stacked array or a sequence of slabs."""
    parts = [stacked[s][:-1] for s in range(n_shards - 1)]
    parts.append(stacked[n_shards - 1])
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return np.concatenate([np.asarray(t) for t in parts])


def dot_weights_axis0(n_cells: int, degree: int, n_shards: int) -> np.ndarray:
    """Per-shard [S, N_loc] reduction weights: 0.5 on duplicated planes."""
    bounds = slab_bounds(n_cells, degree, n_shards)
    out = []
    for s, (b0, b1) in enumerate(bounds):
        w = np.ones(b1 - b0)
        if s > 0:
            w[0] = 0.5
        if s < n_shards - 1:
            w[-1] = 0.5
        out.append(w)
    return np.stack(out)


def shard(arr, n_cells: int, degree: int, devices, dtype) -> ShardedField:
    """A global grid array (NumPy, axis 0 the sharded one) as a field on
    ``devices``, one slab each."""
    st = partition_axis0(np.asarray(arr), n_cells, degree, len(devices))
    return ShardedField(torch.as_tensor(a, dtype=dtype, device=dev)
                        for a, dev in zip(st, devices))


def estimate_eigenvalues_sharded(op, dot, n_iter: int,
                                 v0: ShardedField) -> tuple[float, float]:
    """CG-Lanczos extreme eigenvalues of P^-1 A on the sharded operator
    (the JAX package's ``estimate_eigenvalues_sharded``): A applied with
    its halo exchange, the CG coefficients reduced with the sharded
    ``dot``, the tridiagonal eigenproblem on the host in float64.  For
    levels too large for a single-device twin."""
    idg = op.inv_diag
    r = v0
    z = idg * r
    rz = dot(r, z)
    p = z
    stop = torch.zeros((), dtype=torch.bool, device=rz.device)
    alphas, betas = [], []
    for _ in range(int(n_iter)):
        Ap = op.apply(p)
        pAp = dot(p, Ap)
        bad = stop | (pAp <= 0.0)
        alpha = torch.where(bad, torch.full_like(pAp, float("inf")),
                            rz / torch.where(pAp == 0,
                                             torch.ones_like(pAp), pAp))
        r = r - torch.where(bad, torch.zeros_like(alpha), alpha) * Ap
        z = idg * r
        rz_new = dot(r, z)
        beta = torch.where(bad, torch.zeros_like(rz_new),
                           rz_new / torch.where(rz == 0,
                                                torch.ones_like(rz), rz))
        p = z + beta * p
        stop = bad | (rz_new <= 1e-300)
        rz = rz_new
        alphas.append(alpha)
        betas.append(beta)
    alphas = torch.stack(alphas).cpu().numpy().astype(np.float64)
    betas = torch.stack(betas).cpu().numpy().astype(np.float64)
    valid = np.isfinite(alphas) & (alphas != 0)
    k = int(np.sum(np.cumprod(valid)))
    if k == 0:
        return 1.0, 1.0
    a, b = alphas[:k], betas[:k]
    diag = 1.0 / a
    diag[1:] += b[:-1] / a[:-1]
    off = np.sqrt(np.maximum(b[:-1], 0.0)) / a[:-1]
    T = np.diag(diag)
    if k > 1:
        T += np.diag(off, 1) + np.diag(off, -1)
    ev = np.linalg.eigvalsh(T)
    return float(ev[0]), float(ev[-1])
