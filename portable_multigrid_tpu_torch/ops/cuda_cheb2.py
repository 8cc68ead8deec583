"""B.2: two Chebyshev steps per pass (``csrc/cheb2.cuh``; the pair's modes
in ``cheb2.cu``, ``cheb2lr`` in ``cheb2lr.cu``) and its twin.

Counterpart of ``portable_multigrid_tpu/ops/pallas_cheb2.py``
(``Cheb2Kernel.steps2`` / ``make_cheb2``).  On trimmed state:

    r1 = r  - M A M d      d1 = c0a d  + (c1a / diag) r1
    r2 = r1 - M A M d1     d2 = c0b d1 + (c1b / diag) r2
    x2 = x + d1 + d2

Modes of the pair (:data:`MODES`): ``cheb2`` in (d, r, x) out (r2, d2,
x2); ``cheb2l`` out x2 only; ``chebd2``/``chebd2l`` take x == d;
``cheb2f0``/``cheb2f0l`` start from the rhs b passed in the d slot
(d0 = b / (theta diag), r0 = b, x0 = d0; theta is scal[4]); the kernel
runs them as ``chebd2*`` on (d0, b), d0 written by its elementwise
pre-pass into a scratch field.  :data:`ROUT_MODE`, ``cheb2lr`` (the TPU
kernel's ``rout=True``, ``pallas_cheb2.py:120-129``)
is a recurrence-ending pair that also gives the next V-cycle residual,
r_out = r2 - M A M d2, at the pair's grade and from r2 unrounded: in
(d, r, x), out (x2, r_out), both in the operator's dtype.  It runs on a
kernel of its own, :class:`Cheb2RKernel` (``make_cheb2(op,
rout=True)``), which runs no other mode: its column and rings are those
of three stencil applications.  Each kernel shares the operator's band
arrays, the row sums of K (it contracts K in difference form) and the
diagonal factors
(:class:`~.cuda_laplace.CudaLaplaceOperator`); the twin contracts the
bands with the same difference form.

The grade comes from the operator the kernel is made from: on an exact
(``"banded"``) operator it is the TPU kernel's ``exact=True`` grade; on the
bf16-grade ``"mxu"`` operator it is the production grade of
``make_cheb2(..., exact=False)`` — bf16 coefficients and every
contraction's input rounded to bf16 (``cvt`` and ``mdt``,
pallas_cheb2.py:336-338, :533), with float32 accumulation.  ``sdtype``
stores the recurrence streams: with bfloat16 every mode reads d and r in
bf16 (the ``cheb2f0`` modes read b in float32, and their pre-pass writes
d0 in float32) and writes r2 and d2 in bf16; x and x2 stay float32.

The operator's core also picks the pair's kernel instance: at ``"mxu"``
(float32 only) the tensor-core one (``csrc/cheb2mma.cu``, tile
:func:`cheb2_mma_tile`), at the exact grade the CUDA-core one
(``csrc/cheb2.cuh``, :func:`cheb2_tile`); ``cheb2lr`` runs on the CUDA
cores at either grade.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _build
from .cuda_laplace import (
    EZ,
    IN_BF16,
    OUT_BF16,
    ROUND_BF16,
    SMEM_LIMIT,
    CudaLaplaceOperator,
    _check,
    _suffix,
    apply_trimmed,
    chunk_planes,
    diag_trimmed,
    launch_key,
    march_warps,
    state_dtype,
)

MODES = ("cheb2", "cheb2l", "chebd2", "chebd2l", "cheb2f0", "cheb2f0l")
ROUT_MODE = "cheb2lr"  # the one mode of a rout kernel (csrc/cheb2lr.cu)
# launches per mode (cuda_laplace.launch_key), counted where the wrapper
# launches the kernel: the pair's, and the cheb2lr kernel's apart
LAUNCHES = dict.fromkeys(MODES, 0)
ROUT_LAUNCHES = {ROUT_MODE: 0}

_TY = (16, 8, 6, 4, 2, 1)  # candidate interior rows of a block's column


def cheb2_smem_elems(p: int, ty: int, stages: int = 2) -> int:
    """Shared-memory elements of one block (mirrors smem_elems in
    cheb2.cuh) for ``stages`` stencil applications a pass (2: the pair, 3:
    ``cheb2lr``), with step one on the column grown by G = (stages - 1) p
    and step two on the column grown by G - p: three d windows, two sets
    of step one's z products, ring 1 of 2p+1 planes on step one's column,
    the d1 plane, two sets of step two's z products, ring 2 of 2p+1 planes
    and the lag ring of p+1 (r1, d1) planes on step two's column; the
    epilogues' inputs loaded a plane ahead (r and d on step one's column,
    x on the interior, twice each; three sets of the x rows of each stage,
    2(2p+1) + 3 values each, padded to a multiple of four); with three
    stages also the d2 plane, two sets of step three's z products, ring 3
    on the interior and the lag ring of p+1 r2 planes."""
    R, G = 2 * p + 1, (stages - 1) * p
    wy, wz = ty + 2 * G + 2 * p, EZ + 2 * p
    ey, e2 = ty + 2 * G, ty + 2 * G - 2 * p  # step one's and two's rows
    xrow = -(-(2 * R + 3) // 4) * 4  # 16-byte aligned in float32
    elems = (3 * wy * wz + 4 * wy * EZ + R * 2 * ey * EZ + ey * EZ
             + 4 * ey * EZ + R * 2 * e2 * EZ + (p + 1) * 2 * e2 * EZ
             + 4 * ey * EZ + 2 * ty * EZ + 3 * stages * xrow)
    if stages == 3:
        elems += (e2 * EZ + 4 * e2 * EZ + R * 2 * ty * EZ
                  + (p + 1) * ty * EZ)
    return elems


def cheb2_tile(p: int, itemsize: int, N: int, rout: bool = False,
               nx: int | None = None,
               ny: int | None = None) -> tuple[int, int, int]:
    """(LX, TY, NW) of the launch for an N^3 grid (``nx`` output planes
    along x on a shard's march, ``ny`` output rows along y on a pencil's,
    N by default), as cheb2.cuh's tile_ty / tile_warps compile it;
    ``rout``: the ``cheb2lr`` instance's.

    Step one runs on the column grown by G = p (2p with ``rout``).  TY:
    the largest candidate whose TY + 2G grown rows the block's warps own
    two each and whose buffers fit one block; NW = ceil((TY + 2G) / 2)
    warps.  One block per SM: at p = 4 in float32 one block over TY = 16
    beat two blocks of 8 warps over TY = 8 by 15% on an H100 80GB HBM3 at
    700 W (less y overgrowth for as many warps).  LX: the chunk rule of
    :func:`~.cuda_laplace.chunk_planes` with 2 (G + p) lead-in planes.
    Raises where no tile fits: with ``rout`` p >= 6 in float32 and p >= 4
    in float64."""
    ty = _tile_ty(p, itemsize, rout)
    if ty is None:
        kind = "cheb2lr" if rout else "pair"
        raise ValueError(f"no {kind} tile fits one block at p={p} in "
                         f"{8 * itemsize}-bit floats")
    G = (2 if rout else 1) * p
    columns = -(-N // (EZ - 2 * G)) * -(-(N if ny is None else ny) // ty)
    return (chunk_planes(N if nx is None else nx, columns, 2 * (G + p)), ty,
            (ty + 2 * G + 1) // 2)


def _tile_ty(p: int, itemsize: int, rout: bool) -> int | None:
    """TY of :func:`cheb2_tile` (tile_ty in cheb2.cuh), None where no
    candidate fits."""
    # two grown rows for each of at most 12 warps in float32 (168 registers
    # a thread; at 16 warps, 128 registers, p = 3 and 5 spilled) and 8 in
    # float64 (255 registers): march_warps in march.cuh
    stages = 3 if rout else 2
    G = (stages - 1) * p
    limit = 2 * march_warps(itemsize)
    return next((t for t in _TY if t + 2 * G <= limit
                 and cheb2_smem_elems(p, t, stages) * itemsize <= SMEM_LIMIT),
                None)


# the tensor-core instance's tile (MmaTile in csrc/cheb2mma.cu): row strides
# of the bf16 window and d1 plane and of the float lag ring
_MMA_WS, _MMA_LS = 56, 36
MMA_SMEM_TWO = 113 * 1024  # a block's share of an SM when two fit
_MMA_EY = (32, 24, 16)  # candidate grown rows of a block's column


def _zt_stride(rows: int) -> int:
    """bf16 row stride of z products stored [lane][row] (zt_stride in
    cheb2mma.cu): 16-byte rows whose stride in words is an odd multiple of
    4, so that ldmatrix tiles and packed stores meet no bank conflict."""
    k = -(-rows // 8)
    return 8 * k + (8 if k % 2 == 0 else 0)


def _mma_groups(p: int, ty: int) -> dict:
    """The tensor-core tile's counts at interior rows ``ty`` (MmaTile in
    cheb2mma.cu): EY = ty + 2p grown rows (ey), n1 = EY / 8 step-one
    groups and n2 = ceil(ty / 8) step-two groups of 8 rows, nw = 2 (n1 +
    n2) warps (an m-tile of 16 lanes each), the window's rows padded to
    wyp, and the strides zs1, zs2 of the two sets of z products over the
    rows that the mma tiles read (the y stage's depth, 8 + 2p taps, padded
    to 16 or 32)."""
    ey = ty + 2 * p
    n1, n2 = ey // 8, -(-ty // 8)
    wyp = -(-(ey + 2 * p) // 8) * 8
    ky = 16 if 8 + 2 * p <= 16 else 32
    zr1, zr2 = max(wyp, 8 * (n1 - 1) + ky), max(ey, 8 * (n2 - 1) + ky)
    return dict(ey=ey, n1=n1, n2=n2, groups=n1 + n2, nw=2 * (n1 + n2),
                wyp=wyp, zs1=_zt_stride(zr1), zs2=_zt_stride(zr2))


def cheb2_mma_smem_bytes(p: int, ty: int) -> int:
    """Shared-memory bytes of one tensor-core block (MmaTile::smem_bytes in
    cheb2mma.cu): ring 1 and ring 2 (2p+1 planes of an 8-row group's y
    products as bf16 pairs, 1 KB a group), the lag ring of p+2 (r1, d1)
    planes in float over 8 n2 rows of 36, three sets of the two x rows; in
    bf16 two windows of wyp rows of 56, two sets of step one's Kz and Mz
    products (32 lanes of zs1), the d1 plane (EY rows of 56), two sets of
    step two's z products (32 lanes of zs2) and the z band of Kz and Mz (32
    rows of 56 each)."""
    t = _mma_groups(p, ty)
    xrow = -(-(2 * (2 * p + 1) + 3) // 4) * 4
    words = ((2 * p + 1) * t["groups"] * 256
             + (p + 2) * 2 * 8 * t["n2"] * _MMA_LS + 3 * 2 * xrow)
    halves = (2 * t["wyp"] * _MMA_WS + 4 * 32 * t["zs1"]
              + t["ey"] * _MMA_WS + 4 * 32 * t["zs2"] + 2 * 32 * _MMA_WS)
    return 4 * words + 2 * halves


def _mma_ty(p: int) -> tuple[int, int]:
    """(TY, blocks an SM) of the tensor-core tile (mma_ty, mma_blocks in
    cheb2mma.cu): of the interior rows whose grown column is 32, 24 or 16
    rows, the largest of at least 8 whose block fits twice an SM with at
    most 6 groups; else the largest that fits once."""
    for ey in _MMA_EY:
        ty = ey - 2 * p
        if (ty >= 8 and _mma_groups(p, ty)["groups"] <= 6
                and cheb2_mma_smem_bytes(p, ty) <= MMA_SMEM_TWO):
            return ty, 2
    for ey in _MMA_EY:
        ty = ey - 2 * p
        if ty >= 1 and cheb2_mma_smem_bytes(p, ty) <= SMEM_LIMIT:
            return ty, 1
    raise ValueError(f"no tensor-core pair tile fits one block at p={p}")


def cheb2_mma_tile(p: int, N: int, nx: int | None = None,
                   ny: int | None = None) -> tuple[int, int, int]:
    """(LX, TY, NW) of a tensor-core launch for an N^3 grid (``nx``,
    ``ny`` as in :func:`cheb2_tile`): TY of :func:`_mma_ty`, two warps per
    8-row group of each step, and the chunk rule with 4p lead-in planes and
    the tile's blocks an SM."""
    ty, per_sm = _mma_ty(p)
    columns = -(-N // (EZ - 2 * p)) * -(-(N if ny is None else ny) // ty)
    lx = chunk_planes(N if nx is None else nx, columns, 4 * p, per_sm)
    return lx, ty, _mma_groups(p, ty)["nw"]


def _pair_tile(op: CudaLaplaceOperator, nx=None, ny=None) -> tuple:
    """The tile of the pair's instance on ``op``'s level."""
    N = op.n * op.degree
    if op.core == "mxu":
        return cheb2_mma_tile(op.degree, N, nx, ny)
    itemsize = torch.empty((), dtype=op.dtype).element_size()
    return cheb2_tile(op.degree, itemsize, N, nx=nx, ny=ny)


def cheb2_fits(op: CudaLaplaceOperator, rout: bool = False) -> bool:
    """Whether B.2 has a tile for ``op``'s level (:func:`cheb2_tile`): the
    pair always, ``cheb2lr`` at p <= 5 in float32 and p <= 3 in
    float64."""
    itemsize = torch.empty((), dtype=op.dtype).element_size()
    return _tile_ty(op.degree, itemsize, rout) is not None


def _checked(op, d, r, x, scal, mode, sdtype, xext=None, yext=None):
    """The state dtype of a pass of ``mode`` on ``op``'s level after
    checking its inputs (r None iff the pass starts from the rhs; x given
    iff it is read); on a shard's march ``xext`` = (x_off, nx), with d
    and r extended by their halos, and on a pencil's also ``yext`` =
    (y_off, ny), likewise along y."""
    from_rhs = mode in ("cheb2f0", "cheb2f0l")
    if (r is None) != from_rhs:
        raise ValueError(f"mode {mode!r}: r must be given iff not from rhs")
    if (x is None) != (mode not in ("cheb2", "cheb2l", ROUT_MODE)):
        raise ValueError(f"mode {mode!r}: x must be given iff cheb2, "
                         f"cheb2l or cheb2lr")
    if len(scal) != (5 if from_rhs else 4):
        raise ValueError(f"mode {mode!r}: wrong number of scalars")
    sdtype = state_dtype(op, sdtype)
    N, p = op.n * op.degree, op.degree
    nx = N if xext is None else xext[1]
    ny = N if yext is None else yext[1]
    hx = 0 if xext is None else 1
    hy = 0 if yext is None else 1
    for name, t, dt, h in (("d", d, op.dtype if from_rhs else sdtype,
                            2 * p), ("r", r, sdtype, p),
                           ("x", x, op.dtype, 0)):
        if t is not None:
            _check(op, t, name, dt, (nx + 2 * h * hx, ny + 2 * h * hy, N))
    if not (d.device.type == "cpu" or d.is_cuda):
        raise ValueError(f"unsupported device {d.device}")
    return sdtype


def _flags(op, sdtype, reads_bf16: bool, out_dtype) -> int:
    """StateFlags of a launch: bf16 d and r in, bf16 r2 and d2 out, the
    operator's bf16 grade."""
    bf = sdtype == torch.bfloat16
    return ((IN_BF16 if bf and reads_bf16 else 0)
            | (OUT_BF16 if out_dtype == torch.bfloat16 else 0)
            | (ROUND_BF16 if op.core == "mxu" else 0))


def _bands(op) -> tuple:
    return (op.kband.data_ptr(), op.mband.data_ptr(), op.ksum.data_ptr(),
            op.dK1.data_ptr(), op.dM1.data_ptr())


def _counted(counts: dict, op, mode, sdtype, err) -> None:
    if err:
        raise RuntimeError(f"cheb2 kernel ({mode}) launch failed: "
                           f"CUDA error {err}")
    key = launch_key(mode, op.core, sdtype)
    counts[key] = counts.get(key, 0) + 1


@dataclasses.dataclass
class Cheb2Kernel:
    """Two-step fused recurrence on the operator ``op``'s level; with
    ``xext`` = (x_off, nx) on one shard of the slab-sharded solve
    (:func:`make_cheb2_xext`), with ``yext`` = (y_off, ny) as well on one
    pencil of the 2D-pencil solve (:func:`make_cheb2_pencil`)."""

    op: CudaLaplaceOperator
    tile: tuple  # (LX, TY, NW): cheb2_mma_tile at the mxu core, else
    # cheb2_tile
    xext: tuple | None = None
    yext: tuple | None = None

    def kernel_fn(self):
        """``pmg_cheb2mma`` at the mxu core, else ``pmg_cheb2_f32``/``_f64``
        (``csrc/cheb2.cu``)."""
        if self.op.core == "mxu":
            return _build.build().fn("pmg_cheb2mma")
        return _build.build().fn("pmg_cheb2", _suffix(self.op.dtype))

    def steps2(self, d, r, x, scal, mode: str = "cheb2", sdtype=None):
        """One pass of ``mode``; returns (r2, d2, x2), or (x2,) for "l"
        modes, with r and d (r2 and d2) stored in ``sdtype`` (None: the
        operator's dtype).  On a shard (``xext``) d arrives with 2p planes
        of halo a side and r with p, the neighbours' planes or zeros at
        the global ends (b of the cheb2f0 modes in d's slot, with 2p), and
        x and the outputs are the shard's nx planes; on a pencil
        (``yext`` too) likewise along y, with 2p and p rows a side."""
        if mode not in MODES:
            raise ValueError(f"unknown cheb2 mode {mode!r}"
                             + (": cheb2lr runs on make_cheb2(op, rout=True)"
                                if mode == ROUT_MODE else ""))
        op = self.op
        N = op.n * op.degree
        x_off, nx = (0, N) if self.xext is None else self.xext
        y_off, ny = (0, N) if self.yext is None else self.yext
        sdtype = _checked(op, d, r, x, scal, mode, sdtype, self.xext,
                          self.yext)
        if d.device.type == "cpu":
            if self.yext is not None:
                return cheb2_twin_pencil(op, x_off, nx, y_off, ny, d, r, x,
                                         scal, mode, sdtype)
            if self.xext is not None:
                return cheb2_twin_xext(op, x_off, nx, d, r, x, scal, mode,
                                       sdtype)
            return cheb2_twin(op, d, r, x, scal, mode, sdtype)
        outs = [torch.empty((nx, ny, N), dtype=dt, device=d.device)
                for dt in _out_dtypes(op, mode, sdtype)]
        optrs = [t.data_ptr() for t in outs] + [None] * (3 - len(outs))
        sc = [float(s) for s in scal] + [0.0] * (5 - len(scal))
        # cheb2f0*: the kernel's pre-pass writes d0 = b / (theta diag)
        scratch = torch.empty_like(d) if r is None else None
        fn = self.kernel_fn()
        with torch.cuda.device(d.device):
            err = fn(d.data_ptr(), None if r is None else r.data_ptr(),
                     None if x is None else x.data_ptr(), *optrs,
                     *_bands(op),
                     None if scratch is None else scratch.data_ptr(), *sc,
                     N, nx, x_off, int(self.xext is not None), ny, y_off,
                     int(self.yext is not None), op.degree,
                     MODES.index(mode), *self.tile,
                     _flags(op, sdtype, r is not None, outs[0].dtype),
                     _build.stream_handle(d.device))
        where = ("/pencil" if self.yext is not None
                 else "/xext" if self.xext is not None else "")
        _counted(LAUNCHES, op, mode + where, sdtype, err)
        return tuple(outs)


@dataclasses.dataclass
class Cheb2RKernel:
    """The recurrence-ending pair plus the residual (``cheb2lr``,
    ``csrc/cheb2lr.cu``) on the operator ``op``'s level."""

    op: CudaLaplaceOperator
    tile: tuple  # (LX, TY, NW) of cheb2_tile(..., rout=True)

    def steps2(self, d, r, x, scal, mode: str = ROUT_MODE, sdtype=None):
        """One ``cheb2lr`` pass; returns (x2, r_out), with d and r stored
        in ``sdtype`` (None: the operator's dtype)."""
        if mode != ROUT_MODE:
            raise ValueError(f"mode {mode!r} on a cheb2lr kernel: it runs "
                             f"cheb2lr only (the pair: make_cheb2(op))")
        op = self.op
        sdtype = _checked(op, d, r, x, scal, mode, sdtype)
        if d.device.type == "cpu":
            return cheb2_twin(op, d, r, x, scal, mode, sdtype)
        outs = [torch.empty(d.shape, dtype=dt, device=d.device)
                for dt in _out_dtypes(op, mode, sdtype)]
        fn = _build.build().fn("pmg_cheb2lr", _suffix(op.dtype))
        err = fn(d.data_ptr(), r.data_ptr(), x.data_ptr(),
                 *(t.data_ptr() for t in outs), *_bands(op),
                 *map(float, scal), op.n * op.degree, op.degree, *self.tile,
                 _flags(op, sdtype, True, outs[0].dtype),
                 _build.stream_handle(d.device))
        _counted(ROUT_LAUNCHES, op, mode, sdtype, err)
        return tuple(outs)


def _out_dtypes(op, mode: str, sdtype) -> tuple:
    """x2 and r_out in the operator's dtype; r2 and d2 in the state
    dtype."""
    if mode == "cheb2lr":
        return op.dtype, op.dtype
    return (op.dtype,) if mode.endswith("l") else (sdtype, sdtype, op.dtype)


def cheb2_twin(op: CudaLaplaceOperator, d, r, x, scal, mode: str,
               sdtype=None):
    """Plain torch version of every pair mode: the inputs taken in the
    operator's dtype, the grade of the operator (bf16 contractions on an
    ``"mxu"`` operator), the outputs stored as the kernel stores them."""
    T = op.dtype
    out_dt = _out_dtypes(op, mode, state_dtype(op, sdtype))
    d, r, x = (None if t is None else t.to(T) for t in (d, r, x))
    c0a, c1a, c0b, c1b = scal[:4]
    diag = op.diag_trimmed()
    if mode in ("cheb2f0", "cheb2f0l"):
        r = d
        d = r / (scal[4] * diag)
        x = d
    elif mode in ("chebd2", "chebd2l"):
        x = d
    bands, bf16_grade = (op.kband, op.ksum, op.mband), op.core == "mxu"
    r1 = r - apply_trimmed(*bands, d, bf16_grade)
    d1 = c0a * d + (c1a / diag) * r1
    r2 = r1 - apply_trimmed(*bands, d1, bf16_grade)
    d2 = c0b * d1 + (c1b / diag) * r2
    x2 = x + d1 + d2
    if mode == "cheb2lr":
        # the third stencil application, on r2 as the pair computes it
        outs = x2, r2 - apply_trimmed(*bands, d2, bf16_grade)
    else:
        outs = (x2,) if mode.endswith("l") else (r2, d2, x2)
    return tuple(o.to(dt) for o, dt in zip(outs, out_dt))


def _x_window(op: CudaLaplaceOperator, start: int, count: int) -> tuple:
    """The x factors of global trimmed rows start .. start + count - 1:
    K's and M's bands and K's row sums zero, and the diagonal factors one,
    on rows off the grid (the state is zero there)."""
    N = op.n * op.degree
    lo, hi = max(start, 0), min(start + count, N)

    def take(a, fill):
        out = torch.full(a.shape[:-1] + (count,), fill, dtype=a.dtype,
                         device=a.device)
        out[..., lo - start: hi - start] = a[..., lo:hi]
        return out

    return (take(op.kband, 0.0), take(op.ksum, 0.0), take(op.mband, 0.0),
            take(op.dKt, 1.0), take(op.dMt, 1.0))


def cheb2_twin_xext(op: CudaLaplaceOperator, x_off: int, nx: int, d, r, x,
                    scal, mode: str, sdtype=None):
    """:func:`cheb2_twin` on a shard's march of nx planes from global plane
    ``x_off``: d (or b) with 2p planes of halo a side and r with p; step
    one on the shard grown by p, step two on its own planes, with the
    global x rows at the shard's offset."""
    N = op.n * op.degree
    return _cheb2_twin_ext(op, (x_off, nx, 1), (0, N, 0), d, r, x, scal,
                           mode, sdtype)


def cheb2_twin_pencil(op: CudaLaplaceOperator, x_off: int, nx: int,
                      y_off: int, ny: int, d, r, x, scal, mode: str,
                      sdtype=None):
    """:func:`cheb2_twin_xext` on a pencil's march of nx planes from global
    plane ``x_off`` over ny rows from global row ``y_off``: d (or b) with
    2p planes and 2p rows of halo a side, r with p; step one on the pencil
    grown by p along x and y, step two on its own points, with the global
    x and y rows at the pencil's offsets."""
    return _cheb2_twin_ext(op, (x_off, nx, 1), (y_off, ny, 1), d, r, x,
                           scal, mode, sdtype)


def _cheb2_twin_ext(op: CudaLaplaceOperator, xw: tuple, yw: tuple, d, r, x,
                    scal, mode: str, sdtype):
    """The pair on a march of ``xw`` = (x_off, nx, hx) planes and ``yw`` =
    (y_off, ny, hy) rows: h = 1 on an axis whose inputs carry halos and
    whose step one runs grown by p, h = 0 on one marched whole."""
    T, p = op.dtype, op.degree
    out_dt = _out_dtypes(op, mode, state_dtype(op, sdtype))
    d, r, x = (None if t is None else t.to(T) for t in (d, r, x))
    c0a, c1a, c0b, c1b = scal[:4]
    (x_off, nx, hx), (y_off, ny, hy) = xw, yw
    kw, sw, mw, dkw, dmw = _x_window(op, x_off - 2 * p * hx, nx + 4 * p * hx)
    kyw, syw, myw, dkyw, dmyw = _x_window(op, y_off - 2 * p * hy,
                                          ny + 4 * p * hy)
    diag = diag_trimmed(op.dKt, op.dMt, dkw, dmw, dkyw, dmyw)

    def cut(halo: int, grow: int) -> tuple:
        """Planes and rows of the march grown by ``grow`` (on the axes
        with halos) within arrays with ``halo`` of them a side."""
        lo = halo - grow
        return (slice(lo * hx, lo * hx + nx + 2 * grow * hx),
                slice(lo * hy, lo * hy + ny + 2 * grow * hy))

    rh = p  # r's halo
    if mode in ("cheb2f0", "cheb2f0l"):
        r, rh = d, 2 * p
        d = r / (scal[4] * diag)
    if mode in ("cheb2f0", "cheb2f0l", "chebd2", "chebd2l"):
        x = d[cut(2 * p, 0)]
    bands, grade = (op.kband, op.ksum, op.mband), op.core == "mxu"
    grown = cut(2 * p, p)  # step one: the march grown by p
    r1 = r[cut(rh, p)] - apply_trimmed(*bands, d, grade, (kw, sw, mw),
                                       (kyw, syw, myw))[grown]
    d1 = c0a * d[grown] + (c1a / diag[grown]) * r1
    gx, gy = grown
    own = cut(p, 0)
    r2 = r1[own] - apply_trimmed(*bands, d1, grade,
                                 (kw[:, gx], sw[gx], mw[:, gx]),
                                 (kyw[:, gy], syw[gy], myw[:, gy]))[own]
    d2 = c0b * d1[own] + (c1b / diag[cut(2 * p, 0)]) * r2
    x2 = x + d1[own] + d2
    outs = (x2,) if mode.endswith("l") else (r2, d2, x2)
    return tuple(o.to(dt) for o, dt in zip(outs, out_dt))


def make_cheb2_xext(op: CudaLaplaceOperator, x_off: int,
                    nx: int) -> Cheb2Kernel:
    """The pair kernel on one shard of the slab-sharded solve (the TPU
    kernel's ``xext=True``, pallas_cheb2.py:142-151): ``op`` the global
    operator, the shard's march nx planes from global plane ``x_off``.
    Every output is the single-device pair's at the same plane."""
    if op.dim != 3:
        raise ValueError("the pair kernel B.2 is 3D only")
    N = op.n * op.degree
    if not (0 <= x_off and nx >= 1 and x_off + nx <= N):
        raise ValueError(f"a march of {nx} planes from {x_off} leaves the "
                         f"grid of {N}")
    return Cheb2Kernel(op=op, tile=_pair_tile(op, nx=nx), xext=(x_off, nx))


def make_cheb2_pencil(op: CudaLaplaceOperator, x_off: int, nx: int,
                      y_off: int, ny: int) -> Cheb2Kernel:
    """The pair kernel on one pencil of the 2D-pencil sharded solve (the
    TPU kernel's ``xext=True`` and ``yext=True``, pallas_cheb2.py:142-160):
    ``op`` the global operator, the pencil's march nx planes from global
    plane ``x_off`` over ny rows from global row ``y_off``.  Every output
    is the single-device pair's at the same point."""
    kern = make_cheb2_xext(op, x_off, nx)
    N = op.n * op.degree
    if not (0 <= y_off and ny >= 1 and y_off + ny <= N):
        raise ValueError(f"a march over {ny} rows from {y_off} leaves the "
                         f"grid of {N}")
    return dataclasses.replace(kern, tile=_pair_tile(op, nx=nx, ny=ny),
                               yext=(y_off, ny))


def make_cheb2(op: CudaLaplaceOperator,
               rout: bool = False) -> Cheb2Kernel | Cheb2RKernel:
    """The pair kernel on ``op``'s level, at ``op``'s grade (the production
    bf16 grade on an ``"mxu"`` operator, on the tensor cores); ``rout``:
    the ``cheb2lr`` kernel, which raises ValueError where its tile fits no
    block (:func:`cheb2_tile`)."""
    if op.dim != 3:
        # as in the JAX package (pallas_cheb2.py:59-69)
        raise ValueError("the pair kernel B.2 is 3D only")
    if not rout:
        return Cheb2Kernel(op=op, tile=_pair_tile(op))
    itemsize = torch.empty((), dtype=op.dtype).element_size()
    return Cheb2RKernel(op=op, tile=cheb2_tile(op.degree, itemsize,
                                                op.n * op.degree, True))
