"""B.1: the fused banded Laplace operator (``csrc/laplace.cu``) and its twin.

Counterpart of ``portable_multigrid_tpu/ops/pallas_laplace.py``
(``PallasLaplaceOperator``, ``make_pallas_laplace``).  The operator works on
TRIMMED state — the global last plane per axis dropped, shape (n p)^3, C
order with z contiguous — and computes M A M u with

    A = Kx (x) My (x) Mz + Mx (x) Ky (x) Mz + Mx (x) My (x) Kz

from the GLOBAL mask-folded 1D matrices, plus the single-step Chebyshev
epilogues of the TPU kernel (modes in :data:`MODES`).  Every stiffness
contraction runs in difference form,

    (K u)_i = sum_o K[i, i+o] (u_{i+o} - u_i) + s_i u_i,

with s_i the row sum of the mask-folded K (``ksum``), in the kernel and in
its twin: the TPU kernel's direct banded sum loses the small K u of a
smooth u to cancellation, which left the float32 Q4 r=6 solve 6.6e-5 off
its golden L2 norm.  On a CUDA tensor :meth:`CudaLaplaceOperator.run`
launches the hand-written kernel; on a CPU tensor it runs
:func:`laplace_twin`, the plain torch banded form of the same modes and
outputs.

While :func:`~..utils.profiling.tracing` is on, every pass of
:meth:`CudaLaplaceOperator.run` (the kernel's launch on the card, its twin
on the CPU) adds one to the counter that
:meth:`~CudaLaplaceOperator.pass_key` names,
``pmg.laplace<dim>d.<mode>.p<degree>.n<cells>`` (B.4's are
``pmg.laplace2d.*``, B.5's own ``pmg.elasticity.*``), in the recorder's
``counts`` and in those of the V-cycle's active
:class:`~..utils.profiling.SpanPlan`; while tracing is off nothing is
counted there (:data:`LAUNCHES` counts the kernel's launches always).

One mode reads the full grid, as the TPU kernel's ``"residual"`` does
(``pallas_laplace.py:217``): the first half of a smoothing step of the
full-grid smoother (``FusedChebyshev(trimmed_io=False)``), r0 = rhs - M A M u
and d0 = r0 / (theta diag) from u and rhs on the full (n p + 1)^3 grid,
written trimmed in the operator's dtype (:data:`FULL_MODES`).  The kernel
reads both at the full grid's strides in its one march, with no trim copy.

Two precision options of the TPU kernel are ported, for float32 only:

  * the state dtype (``sdtype``, JAX's ``sdtype="bf16"``): the recurrence
    streams r and d of ``residual3t`` and the cheb family are stored in
    ``torch.bfloat16`` (:func:`io_dtypes`, JAX's ``out_dtypes``), while the
    kernel computes in float32 and x and every residual stay float32;
  * the ``"mxu"`` core (:func:`make_cuda_laplace` with ``core="mxu"``): the
    bf16-grade operator of the Chebyshev recurrence, the function the TPU
    kernel's bf16 matrix core computes (``pallas_laplace.py:532-541``).
    The band coefficients are rounded to bf16, and so are u, Mz u and
    Kz u, My Mz u and (Ky Mz + My Kz) u, each accumulated in float32.  The
    TPU core's dense matrices only feed its matrix unit, and their zeros
    add nothing, so the band gives the same products.  It keeps the
    difference form of K with the row sums of the ROUNDED bands (``ksum``),
    so that it is the direct banded sum of the TPU core up to float32
    rounding: at bf16 grade the input's rounding, not the cancellation that
    the difference form avoids, sets the error.  The TPU core assembles x
    and y per block and adds the boundary rows of two blocks after rounding
    each half; the global bands round the whole entry, so the two agree at
    bf16 grade, not bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import ClassVar

import numpy as np
import torch

from .. import _build
from ..fem.space import FESpace
from ..utils import profiling
from ..utils.tensors import to_tensor
from .laplace import (
    assembled_1d_matrices,
    diagonal_1d_factors,
    separable_inv_diag,
    separable_mask,
)
from .transfer import pad_last_planes, trim_last_planes

MODES = ("apply", "residual1t", "residual3t", "cheb", "chebl", "chebd",
         "chebdl")
# B.1's modes on the full grid: u and rhs untrimmed, the outputs trimmed
FULL_MODES = ("residual",)
# every mode, in the order of LaplaceMode in csrc/common.cuh
KERNEL_MODES = MODES + FULL_MODES
CORES = ("banded", "mxu")
# kernel launches per mode, counted where the wrapper launches the kernel
# (launch_key: a mode at the mxu grade or at bf16 state has its own key)
LAUNCHES = dict.fromkeys(KERNEL_MODES, 0)
COUNTER = "pmg.laplace"  # the prefix of the pass counter's keys
# StateFlags of csrc/common.cuh: the stencil input and the first epilogue
# input are bf16; the recurrence outputs are bf16; the bf16 operator grade
IN_BF16, OUT_BF16, ROUND_BF16 = 1, 2, 4


def io_dtypes(mode: str, dtype, sdtype) -> tuple[tuple, tuple]:
    """(input dtypes, output dtypes) of a mode, the stencil input first,
    with the recurrence streams r and d stored in ``sdtype`` (the TPU
    kernel's ``out_dtypes``, pallas_laplace.py:287-292): residual3t reads
    u and rhs in ``dtype`` and writes r0, d0 in ``sdtype`` and x0 in
    ``dtype``; the cheb family reads d and r in ``sdtype`` and x in
    ``dtype``, and writes r', d' in ``sdtype`` and x' in ``dtype``; the
    untrimmed residual keeps every stream in ``dtype``."""
    T, S = dtype, sdtype
    ins = {"apply": (T,), "residual1t": (T, T), "residual3t": (T, T),
           "cheb": (S, S, T), "chebl": (S, S, T), "chebd": (S, S),
           "chebdl": (S, S), "residual": (T, T)}[mode]
    outs = {"apply": (T,), "residual1t": (T,), "residual3t": (S, S, T),
            "cheb": (S, S, T), "chebl": (T,), "chebd": (S, S, T),
            "chebdl": (T,), "residual": (T, T)}[mode]
    return ins, outs


def launch_key(mode: str, core: str, sdtype) -> str:
    """The launch counters' key of a mode: "cheb" at the exact grade and
    the operator's state dtype, "cheb/mxu/bf16" at the mxu grade and
    bfloat16 state, "residual3t/bf16", ..."""
    return (mode + ("/mxu" if core == "mxu" else "")
            + ("/bf16" if sdtype == torch.bfloat16 else ""))


def state_dtype(op, sdtype):
    """The storage dtype of the recurrence streams: the operator's dtype
    for None; bfloat16 only on a float32 operator whose kernel takes it."""
    if sdtype is None or sdtype == op.dtype:
        return op.dtype
    if sdtype != torch.bfloat16:
        raise ValueError(f"state dtype {sdtype}: the kernels store the "
                         f"recurrence in the operator's dtype or bfloat16")
    if op.dtype != torch.float32 or not op.bf16_state:
        raise ValueError(f"bfloat16 state needs a float32 operator whose "
                         f"kernel stores it, not {type(op).__name__} in "
                         f"{op.dtype}")
    return sdtype


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (to nearest even) and back to its dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def round_factors_bf16(a: np.ndarray) -> np.ndarray:
    """Host factors (float64) rounded to bfloat16 at once, as the TPU
    core's bf16 matrices are, and back to float64."""
    return torch.as_tensor(a).to(torch.bfloat16).double().numpy()


SMEM_LIMIT = 227 * 1024  # shared memory one H100 block may use
SMS = 132  # streaming multiprocessors of the H100 SXM
EZ = 32  # z extent of a marching column's rows: one warp (kEZ in march.cuh)


def march_smem_elems(p: int, ty: int) -> int:
    """Shared-memory elements of one B.1 block (mirrors smem_elems in
    laplace.cu): three u windows of (TY + 2p) x (32 + 2p), two sets of the
    z products (2 x (TY + 2p) x 32), the ring of 2p+1 planes of the two y-z
    products on the TY x 32 column, two sets of the epilogue's three inputs
    and three x rows of 2(2p+1) + 3 values, padded to a multiple of four."""
    R, wy, wz = 2 * p + 1, ty + 2 * p, EZ + 2 * p
    xrow = -(-(2 * R + 3) // 4) * 4
    return (3 * wy * wz + 4 * wy * EZ + R * 2 * ty * EZ + 6 * ty * EZ
            + 3 * xrow)


def march_warps(itemsize: int) -> int:
    """Warps of one marching block (march_warps in march.cuh): 12 in
    float32 (168 registers a thread), 8 in float64 (255); one block per
    SM."""
    return 12 if itemsize == 4 else 8


def chunk_planes(N: int, columns: int, lead: int, per_sm: int = 1) -> int:
    """Output planes LX of an x chunk.  A block marches LX + ``lead``
    planes one after the other and the grid's ``columns`` columns run in
    waves of ``per_sm`` blocks per SM, so N is cut into k chunks of
    LX = ceil(N / k) planes, the k that minimises waves x (LX + lead),
    ties to the larger chunk."""

    def cost(lx):
        return -(-columns * -(-N // lx) // (SMS * per_sm)) * (lx + lead)

    chunks = {-(-N // k) for k in range(1, max(N // 2, 1) + 1)}
    return min(chunks, key=lambda lx: (cost(lx), -lx))


def laplace_tile(p: int, itemsize: int, N: int, nx: int | None = None,
                 ny: int | None = None) -> tuple[int, int, int]:
    """(LX, TY, NW) of the B.1 launch for an N^3 grid (``nx`` output
    planes along x on a slab or a pencil, ``ny`` output rows along y on a
    pencil, N by default), as laplace.cu compiles it: NW =
    :func:`march_warps` warps of one block per SM, two rows of the column
    each (TY = 2 NW), and x chunks of LX planes with 2p lead-in planes."""
    nw = march_warps(itemsize)
    ty = 2 * nw
    if march_smem_elems(p, ty) * itemsize > SMEM_LIMIT:
        raise ValueError(f"no laplace tile fits shared memory at p={p}")
    columns = -(-N // EZ) * -(-(N if ny is None else ny) // ty)
    return chunk_planes(N if nx is None else nx, columns, 2 * p), ty, nw


def to_bands(W: np.ndarray, p: int) -> np.ndarray:
    """[L, L] banded matrix -> bands [2p+1, L]: bands[p+o, i] = W[i, i+o]
    (zero where i+o is out of range)."""
    L = W.shape[0]
    bands = np.zeros((2 * p + 1, L))
    for o in range(-p, p + 1):
        for i in range(max(0, -o), min(L, L - o)):
            bands[p + o, i] = W[i, i + o]
    return bands


def banded(u: torch.Tensor, bands: torch.Tensor, axis: int,
           rowsum: torch.Tensor | None = None) -> torch.Tensor:
    """sum_o bands[p+o, i] u[i+o] along ``axis`` (zero beyond the grid); with
    ``rowsum``, in difference form: sum_o bands[p+o, i] (u[i+o] - u[i])
    + rowsum[i] u[i]."""
    p = (bands.shape[0] - 1) // 2
    u = torch.movedim(u, axis, 0)
    L = u.shape[0]
    shape = (L,) + (1,) * (u.ndim - 1)
    padded = torch.nn.functional.pad(u, (0, 0) * (u.ndim - 1) + (p, p))
    out = torch.zeros_like(u) if rowsum is None else rowsum.reshape(shape) * u
    for o in range(-p, p + 1):
        v = padded[p + o: p + o + L]
        if rowsum is not None:
            v = v - u
        out = out + bands[p + o].reshape(shape) * v
    return torch.movedim(out, 0, axis)


def _padded_bands(bands, length: int) -> tuple:
    """(kband, ksum, mband) of some rows, zero-extended to ``length``
    rows."""
    extra = length - bands[0].shape[1]
    return tuple(torch.nn.functional.pad(t, (0, extra)) for t in bands)


def apply_trimmed(kband: torch.Tensor, ksum: torch.Tensor,
                  mband: torch.Tensor, u: torch.Tensor,
                  bf16_grade: bool = False, xbands=None,
                  ybands=None) -> torch.Tensor:
    """M A M u on trimmed 3D state in the kernels' order, z, then y, then
    x: Kx (My Mz u) + Mx (Ky Mz u + My Kz u), every K contraction in
    difference form.  ``bf16_grade`` rounds each contraction's input to
    bf16, as the ``"mxu"`` core and B.2's production grade do.
    ``xbands`` (kband, ksum, mband of X rows) are the x factors where they
    differ from the z ones: the output is the first X planes, and the
    input may carry more (a slab's x-full input, a shard's window);
    ``ybands`` (of Y rows) likewise along y (a pencil's)."""
    rnd = round_bf16 if bf16_grade else (lambda t: t)
    u = rnd(u)
    b = rnd(banded(u, mband, 2))
    a = rnd(banded(u, kband, 2, ksum))
    if ybands is None:
        mb = rnd(banded(b, mband, 1))
        s = rnd(banded(b, kband, 1, ksum) + banded(a, mband, 1))
    else:
        ky, sy, my = _padded_bands(ybands, u.shape[1])
        rows = ybands[0].shape[1]
        mb = rnd(banded(b, my, 1))[:, :rows]
        s = rnd(banded(b, ky, 1, sy) + banded(a, my, 1))[:, :rows]
    if xbands is None:
        return banded(mb, kband, 0, ksum) + banded(s, mband, 0)
    kx, sx, mx = _padded_bands(xbands, u.shape[0])
    return (banded(mb, kx, 0, sx) + banded(s, mx, 0))[:xbands[0].shape[1]]


def diag_trimmed(dKt: torch.Tensor, dMt: torch.Tensor, dKx=None,
                 dMx=None, dKy=None, dMy=None) -> torch.Tensor:
    """Separable diagonal on the trimmed grid (raw values on constrained
    entries, as the kernels rebuild it); ``dKx``/``dMx`` and
    ``dKy``/``dMy`` the x and y factors where they differ from the z
    ones."""
    dKx = dKt if dKx is None else dKx
    dMx = dMt if dMx is None else dMx
    dKy = dKt if dKy is None else dKy
    dMy = dMt if dMy is None else dMy
    x = lambda v: v.reshape(-1, 1, 1)
    y = lambda v: v.reshape(1, -1, 1)
    z = lambda v: v.reshape(1, 1, -1)
    return (x(dKx) * y(dMy) * z(dMt)
            + x(dMx) * (y(dKy) * z(dMt) + y(dMy) * z(dKt)))


@dataclasses.dataclass
class CudaLaplaceOperator:
    """3D Q_p Laplace operator for the kernel path, on one device.

    The state, the shapes and :meth:`apply` / :meth:`run` are written for
    any ``dim``; a subclass names its kernel, its launch counts, its twin,
    the state they take and its diagonal
    (``ops.cuda_laplace2d.CudaLaplace2D`` for 2D)."""

    degree: int
    n: int  # cells per axis
    mask1: torch.Tensor  # [N] free-DoF mask factor (same on every axis)
    dK1: torch.Tensor  # [N] assembled stiffness diagonal (h-folded)
    dM1: torch.Tensor  # [N] assembled mass diagonal
    kband: torch.Tensor  # [2p+1, N-1] bands of the trimmed mask-folded K
    ksum: torch.Tensor  # [N-1] row sums of the trimmed mask-folded K
    mband: torch.Tensor  # [2p+1, N-1] bands of the trimmed mask-folded M
    tile: tuple  # the kernel's launch tile: (LX, TY, NW) of laplace_tile
    dim: int = 3
    # "banded" (exact) or "mxu" (the bf16 grade of the recurrence, float32)
    core: str = "banded"
    kernel: ClassVar[str] = "pmg_laplace"  # C entry point (without dtype)
    launches: ClassVar[dict] = LAUNCHES
    # B.2 runs two Chebyshev steps of this operator per pass (3D Laplace
    # only, as in the JAX package)
    pair_kernel: ClassVar[bool] = True
    # the kernel stores the recurrence streams in bf16 (StateFlags)
    bf16_state: ClassVar[bool] = True
    # the modes on the full grid that the kernel takes
    full_modes: ClassVar[tuple] = FULL_MODES

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return (self.n * self.degree + 1,) * self.dim

    @property
    def shape(self) -> tuple[int, ...]:
        """Shape of a full-grid field (one component)."""
        return self.grid_shape

    @property
    def trimmed_shape(self) -> tuple[int, ...]:
        return (self.n * self.degree,) * self.dim

    @property
    def n_dofs(self) -> int:
        return int(np.prod(self.shape))

    @property
    def dtype(self):
        return self.mask1.dtype

    @property
    def device(self):
        return self.mask1.device

    @property
    def dKt(self) -> torch.Tensor:
        return self.dK1[:-1]

    @property
    def dMt(self) -> torch.Tensor:
        return self.dM1[:-1]

    @property
    def mask(self) -> torch.Tensor:
        return separable_mask((self.mask1,) * self.dim)

    @property
    def inv_diag(self) -> torch.Tensor:
        return separable_inv_diag((self.mask1,) * self.dim,
                                  (self.dK1,) * self.dim,
                                  (self.dM1,) * self.dim)

    def diag_trimmed(self) -> torch.Tensor:
        return diag_trimmed(self.dKt, self.dMt)

    def apply(self, u: torch.Tensor) -> torch.Tensor:
        """Full vmult A_eff = M A M + (I - M): trim, run the kernel, pad,
        combine (the wrapper side of pallas_laplace.py:195-210)."""
        u = u.reshape(self.shape)
        (au,) = self.run("apply", trim_last_planes(u, self.dim).contiguous())
        au = pad_last_planes(au, self.dim)
        m = self.mask
        return m * au + (1.0 - m) * u

    def run(self, mode: str, u: torch.Tensor, ins=(), scal=(),
            sdtype=None):
        """One pass of ``mode`` on trimmed state (u and rhs on the full
        grid in a mode of ``full_modes``); returns the output tuple, on
        trimmed state.

        ``ins``: (rhs,) for residual1t/residual3t/residual, (r, x) for
        cheb/chebl, (r,) for chebd/chebdl.  ``scal``: (theta,) for
        residual3t and residual, (c0, c1) for the cheb family.
        ``sdtype``: the storage dtype of the recurrence streams
        (:func:`io_dtypes`; None: the operator's).  Counted while tracing
        is on (:meth:`pass_key`)."""
        full = mode in self.full_modes
        if mode not in MODES and not full:
            raise ValueError(f"unknown laplace mode {mode!r}: the kernels "
                             f"take modes {MODES + self.full_modes}")
        sdtype = state_dtype(self, sdtype)
        in_dt, out_dt = io_dtypes(mode, self.dtype, sdtype)
        if len(ins) != len(in_dt) - 1:
            raise ValueError(f"mode {mode!r} takes {len(in_dt) - 1} inputs")
        for k, (t, dt) in enumerate(zip((u,) + tuple(ins), in_dt)):
            _check(self, t, "u" if k == 0 else f"input {k - 1}", dt,
                   self.grid_shape if full else None)
        if u.device.type == "cpu":
            outs = self.twin(mode, u, ins, scal, sdtype)
        elif not u.is_cuda:
            raise ValueError(f"unsupported device {u.device}")
        else:
            flags = ((IN_BF16 if in_dt[0] == torch.bfloat16 else 0)
                     | (OUT_BF16 if len(out_dt) == 3
                        and out_dt[0] == torch.bfloat16 else 0)
                     | (ROUND_BF16 if self.core == "mxu" else 0))
            outs = _launch(self, KERNEL_MODES.index(mode), u, ins, scal,
                           out_dt, flags, launch_key(mode, self.core, sdtype),
                           *((self.trimmed_shape, self.kernel_sizes(True))
                             if full else ()))
        if profiling.active() is not None:
            profiling.count(self.pass_key(mode))
        return outs

    def pass_key(self, mode: str) -> str:
        """The pass counter's key of ``mode`` on this operator,
        ``pmg.laplace<dim>d.<mode>.p<degree>.n<cells>``, as
        ``pmg.laplace2d.cheb.p1.n512``."""
        return f"{COUNTER}{self.dim}d.{mode}.p{self.degree}.n{self.n}"

    def twin(self, mode: str, u: torch.Tensor, ins=(), scal=(),
             sdtype=None):
        """The mode in plain torch on any device: the inputs taken in the
        operator's dtype (a full-grid mode's trimmed first), the outputs
        stored as the kernel stores them."""
        T = self.dtype
        _, out_dt = io_dtypes(mode, T, state_dtype(self, sdtype))
        if mode in self.full_modes:
            u, *ins = (trim_last_planes(t, self.dim).contiguous()
                       for t in (u,) + tuple(ins))
        outs = self.raw_twin(mode, u.to(T), tuple(t.to(T) for t in ins),
                             scal)
        return tuple(o.to(dt) for o, dt in zip(outs, out_dt))

    def raw_twin(self, mode: str, u: torch.Tensor, ins=(), scal=()):
        return laplace_twin(self, mode, u, ins, scal)

    @staticmethod
    def pick_tile(p: int, itemsize: int, N: int) -> tuple:
        return laplace_tile(p, itemsize, N)

    def kernel_fn(self):
        """The C entry point that runs this operator's launches."""
        return _build.build().fn(self.kernel, _suffix(self.dtype))

    def kernel_state(self) -> tuple:
        """Operator arrays handed to the kernel, in its argument order: the
        z, the y and the x factors (on the cube the same ones)."""
        cube = self.kband, self.ksum, self.mband, self.dK1, self.dM1
        return cube * 3

    def kernel_scalars(self) -> tuple:
        """Operator scalars handed to the kernel after its arrays."""
        return ()

    def kernel_sizes(self, full: bool = False) -> tuple:
        """The grid's extents handed to the kernel before the degree: N and
        (B.1) the output and input rows along y, then along x, and the
        input rows' length; N + 1 for the inputs of a ``full`` mode."""
        N = self.n * self.degree
        M = N + 1 if full else N
        return N, N, M, N, M, M


# the modes of a slab of the sharded solve (pallas_laplace.py:232-242), on
# x-full input, and the kernel mode whose epilogue each runs
SLAB_MODES = {"apply": "apply", "residual1f": "residual1t",
              "residual3f": "residual3t", "chebf": "cheb"}


@dataclasses.dataclass
class CudaLaplaceSlab(CudaLaplaceOperator):
    """B.1 on one shard's slab of the slab-sharded solve: the TPU kernel's
    ``make_pallas_slab`` (``xmask="vector"``) with its modes ``chebf``,
    ``residual3f`` and ``residual1f`` (:data:`SLAB_MODES`).

    y and z are the cube's (N = n p trimmed points, the global factors);
    x has factors of its own: the bands and K row sums of the slab-partial
    1D assembly over its ``n_loc`` cells with the shard's slice of the
    global x mask folded in (interior shard boundaries are unmasked, so
    their rows carry only the slab's cells), and the shard's slices of the
    global diagonal factors.  Every mode takes the x-FULL input, the
    shard's L = n_loc p trimmed planes and its right neighbour's first
    plane, (L + 1, N, N), and writes L planes: the slab's last plane, and
    the left neighbour's cells on plane 0, are the caller's
    (``parallel/sharding.py``).  The state is float32 or float64 in every
    stream, at either core."""

    n_loc: int = 0  # the slab's cells along x
    xkband: torch.Tensor = None  # [2p+1, L] bands of the masked partial K
    xksum: torch.Tensor = None  # [L] its row sums
    xmband: torch.Tensor = None  # [2p+1, L] bands of the masked partial M
    mask1x: torch.Tensor = None  # [L+1] the shard's slice of the x mask
    dK1x: torch.Tensor = None  # [L+1] ... of the stiffness diagonal factor
    dM1x: torch.Tensor = None  # [L+1] ... of the mass diagonal factor
    full_modes: ClassVar[tuple] = ()

    @property
    def grid_shape(self) -> tuple[int, ...]:
        """The full slab, shared planes included."""
        N = self.n * self.degree
        return self.n_loc * self.degree + 1, N + 1, N + 1

    @property
    def trimmed_shape(self) -> tuple[int, ...]:
        N = self.n * self.degree
        return self.n_loc * self.degree, N, N

    @property
    def input_shape(self) -> tuple[int, ...]:
        """The x-full input: one plane more than the trimmed state."""
        L, N, _ = self.trimmed_shape
        return L + 1, N, N

    @property
    def mask(self) -> torch.Tensor:
        return separable_mask((self.mask1x, self.mask1, self.mask1))

    @property
    def inv_diag(self) -> torch.Tensor:
        return separable_inv_diag((self.mask1x, self.mask1, self.mask1),
                                  (self.dK1x, self.dK1, self.dK1),
                                  (self.dM1x, self.dM1, self.dM1))

    def diag_trimmed(self) -> torch.Tensor:
        L = self.trimmed_shape[0]
        return diag_trimmed(self.dKt, self.dMt, self.dK1x[:L], self.dM1x[:L])

    def run(self, mode: str, u: torch.Tensor, ins=(), scal=(), sdtype=None):
        """One pass of a slab mode on the x-full ``u``: ``ins`` (rhs,) for
        residual1f/residual3f and (r, x) for chebf, trimmed; ``scal``
        (theta,) for residual3f and (c0, c1) for chebf."""
        if mode not in SLAB_MODES:
            raise ValueError(f"unknown slab mode {mode!r}: a slab runs "
                             f"{tuple(SLAB_MODES)}")
        if sdtype not in (None, self.dtype):
            raise ValueError("a slab keeps its state in its own dtype")
        base = SLAB_MODES[mode]
        in_dt, out_dt = io_dtypes(base, self.dtype, self.dtype)
        if len(ins) != len(in_dt) - 1:
            raise ValueError(f"mode {mode!r} takes {len(in_dt) - 1} inputs")
        _check(self, u, "u", shape=self.input_shape)
        for k, t in enumerate(ins):
            _check(self, t, f"input {k}")
        if u.device.type == "cpu":
            return self.twin(mode, u, ins, scal)
        if not u.is_cuda:
            raise ValueError(f"unsupported device {u.device}")
        key = mode + "/slab" + ("/mxu" if self.core == "mxu" else "")
        return _launch(self, MODES.index(base), u, ins, scal, out_dt,
                       ROUND_BF16 if self.core == "mxu" else 0, key,
                       self.trimmed_shape)

    def twin(self, mode: str, u: torch.Tensor, ins=(), scal=(), sdtype=None):
        raw = apply_trimmed(self.kband, self.ksum, self.mband, u,
                            self.core == "mxu",
                            (self.xkband, self.xksum, self.xmband))
        L = self.trimmed_shape[0]
        return twin_epilogue(self, SLAB_MODES[mode], raw, u[:L], ins, scal)

    def kernel_state(self) -> tuple:
        cube = self.kband, self.ksum, self.mband, self.dK1, self.dM1
        return cube * 2 + (self.xkband, self.xksum, self.xmband, self.dK1x,
                           self.dM1x)

    def kernel_sizes(self) -> tuple:
        L, N, _ = self.trimmed_shape
        return N, N, N, L, L + 1, N


@dataclasses.dataclass
class CudaLaplacePencil(CudaLaplaceSlab):
    """B.1 on one pencil of the 2D-pencil sharded solve: the TPU kernel's
    ``make_pallas_slab2d`` (pallas_laplace.py:1020, ``xmask`` and ``ymask``
    ``"vector"``) in its one mode on that path, ``apply``, at the exact
    core.

    x is the slab's (:class:`CudaLaplaceSlab`); y has factors of its own in
    the same way: the bands and K row sums of the partial 1D assembly over
    the pencil's ``n_loc_y`` cells with the shard's slice of the global y
    mask folded in, and the shard's slices of the diagonal factors; z keeps
    the global factors.  ``apply`` takes the x-and-y-FULL input, the
    pencil's Lx x Ly trimmed points and its neighbours' shared plane and
    row, (Lx + 1, Ly + 1, N), and writes (Lx, Ly, N): the pencil's last x
    plane and last y row, and its neighbours' cells on plane 0 and row 0,
    are the caller's (``parallel/mesh2d.py``)."""

    n_loc_y: int = 0  # the pencil's cells along y
    ykband: torch.Tensor = None  # [2p+1, Ly] bands of the masked partial K
    yksum: torch.Tensor = None  # [Ly] its row sums
    ymband: torch.Tensor = None  # [2p+1, Ly] bands of the masked partial M
    mask1y: torch.Tensor = None  # [Ly+1] the shard's slice of the y mask
    dK1y: torch.Tensor = None  # [Ly+1] ... of the stiffness diagonal factor
    dM1y: torch.Tensor = None  # [Ly+1] ... of the mass diagonal factor

    @property
    def grid_shape(self) -> tuple[int, ...]:
        """The full pencil, shared planes and rows included."""
        p = self.degree
        return self.n_loc * p + 1, self.n_loc_y * p + 1, self.n * p + 1

    @property
    def trimmed_shape(self) -> tuple[int, ...]:
        p = self.degree
        return self.n_loc * p, self.n_loc_y * p, self.n * p

    @property
    def input_shape(self) -> tuple[int, ...]:
        """The x-and-y-full input: a plane and a row more than the trimmed
        state."""
        Lx, Ly, N = self.trimmed_shape
        return Lx + 1, Ly + 1, N

    @property
    def mask(self) -> torch.Tensor:
        return separable_mask((self.mask1x, self.mask1y, self.mask1))

    @property
    def inv_diag(self) -> torch.Tensor:
        return separable_inv_diag((self.mask1x, self.mask1y, self.mask1),
                                  (self.dK1x, self.dK1y, self.dK1),
                                  (self.dM1x, self.dM1y, self.dM1))

    def diag_trimmed(self) -> torch.Tensor:
        Lx, Ly, _ = self.trimmed_shape
        return diag_trimmed(self.dKt, self.dMt, self.dK1x[:Lx],
                            self.dM1x[:Lx], self.dK1y[:Ly], self.dM1y[:Ly])

    def run(self, mode: str, u: torch.Tensor, ins=(), scal=(), sdtype=None):
        """``apply`` on the x-and-y-full ``u``; returns (raw,)."""
        if mode != "apply":
            raise ValueError(f"unknown pencil mode {mode!r}: a pencil runs "
                             f"'apply'")
        if ins or scal or sdtype not in (None, self.dtype):
            raise ValueError("a pencil's apply takes u alone")
        _check(self, u, "u", shape=self.input_shape)
        if u.device.type == "cpu":
            return self.twin(mode, u)
        if not u.is_cuda:
            raise ValueError(f"unsupported device {u.device}")
        return _launch(self, MODES.index("apply"), u, (), (), (self.dtype,),
                       0, "apply/pencil", self.trimmed_shape)

    def twin(self, mode: str, u: torch.Tensor, ins=(), scal=(), sdtype=None):
        return (apply_trimmed(self.kband, self.ksum, self.mband, u, False,
                              (self.xkband, self.xksum, self.xmband),
                              (self.ykband, self.yksum, self.ymband)),)

    def kernel_state(self) -> tuple:
        return ((self.kband, self.ksum, self.mband, self.dK1, self.dM1,
                 self.ykband, self.yksum, self.ymband, self.dK1y, self.dM1y,
                 self.xkband, self.xksum, self.xmband, self.dK1x,
                 self.dM1x))

    def kernel_sizes(self) -> tuple:
        Lx, Ly, N = self.trimmed_shape
        return N, Ly, Ly + 1, Lx, Lx + 1, N


def cuda_laplace_pencil_from_factors(degree: int, n: int, n_loc: tuple, m1,
                                     K1, M1, gK, gM, xs: tuple, ys: tuple,
                                     dtype=torch.float32, device="cpu"
                                     ) -> CudaLaplacePencil:
    """Pack a pencil's operator (NumPy, float64) at the exact core: the
    global 1D factors of z (``m1``, ``K1``, ``M1``, ``gK``, ``gM``, length
    n p + 1), and per sharded axis, for the pencil's ``n_loc`` = (cells
    along x, along y), ``xs`` and ``ys`` = (mask slice, partial K, partial
    M, dK slice, dM slice), each of length n_loc p + 1
    (:func:`partial_bands`)."""
    slab = cuda_laplace_slab_from_factors(degree, n, n_loc[0], m1, K1, M1,
                                          gK, gM, *xs, dtype, device)
    ykband, yksum, ymband = partial_bands(*ys[:3], degree)
    t = functools.partial(to_tensor, dtype=dtype, device=device)
    fields = {f.name: getattr(slab, f.name) for f in dataclasses.fields(slab)}
    itemsize = torch.empty((), dtype=dtype).element_size()
    fields["tile"] = laplace_tile(degree, itemsize, n * degree,
                                  nx=n_loc[0] * degree, ny=n_loc[1] * degree)
    return CudaLaplacePencil(**fields, n_loc_y=n_loc[1], ykband=t(ykband),
                             yksum=t(yksum), ymband=t(ymband),
                             mask1y=t(ys[0]), dK1y=t(ys[3]), dM1y=t(ys[4]))


def cuda_laplace_slab_from_factors(degree: int, n: int, n_loc: int, m1, K1,
                                   M1, gK, gM, mx, Kx, Mx, gKx, gMx,
                                   dtype=torch.float32, device="cpu",
                                   core: str = "banded") -> CudaLaplaceSlab:
    """Pack a slab's operator (NumPy, float64): the global 1D factors of
    y and z (``m1``, ``K1``, ``M1``, ``gK``, ``gM``, length n p + 1), and
    the slab's x factors: the shard's slices ``mx``, ``gKx``, ``gMx`` of
    the global mask and diagonal factors and the slab-partial assembly
    ``Kx``, ``Mx`` over its n_loc cells, all of length n_loc p + 1.  The
    x row sums come from the mask, as :func:`row_sums` takes them: the
    rows of a partial assembly sum to zero as the global ones do.
    ``core="mxu"`` rounds every band to bf16 and takes K's row sums from
    the rounded bands."""
    cube = cuda_laplace_from_factors(degree, n, m1, K1, M1, gK, gM, dtype,
                                     device, core=core)
    L = n_loc * degree
    xkband, xksum, xmband = partial_bands(mx, Kx, Mx, degree, core)
    t = functools.partial(to_tensor, dtype=dtype, device=device)
    fields = {f.name: getattr(cube, f.name) for f in dataclasses.fields(cube)}
    itemsize = torch.empty((), dtype=dtype).element_size()
    fields["tile"] = laplace_tile(degree, itemsize, n * degree, nx=L)
    return CudaLaplaceSlab(**fields, n_loc=n_loc, xkband=t(xkband),
                           xksum=t(xksum), xmband=t(xmband), mask1x=t(mx),
                           dK1x=t(gKx), dM1x=t(gMx))


def partial_bands(m, K, M, degree: int, core: str = "banded") -> tuple:
    """(kband, ksum, mband) of a shard's partial 1D assembly ``K``, ``M``
    (NumPy, float64, L + 1 rows) with its slice ``m`` of the global mask
    folded in, over its first L rows: the kernel's factors of a sharded
    axis.  The row sums come from the mask, as :func:`row_sums` takes
    them; ``core="mxu"`` rounds the bands to bf16 and takes K's row sums
    from the rounded bands."""
    m, K, M = (np.asarray(a, np.float64) for a in (m, K, M))
    L = K.shape[0] - 1
    kband = to_bands(m[:, None] * K * m[None, :], degree)[:, :L]
    mband = to_bands(m[:, None] * M * m[None, :], degree)[:, :L]
    ksum = row_sums(K, m)
    if core == "mxu":
        kband, mband = map(round_factors_bf16, (kband, mband))
        ksum = kband.sum(axis=0)
    return kband, ksum, mband


def laplace_twin(op: CudaLaplaceOperator, mode: str, u: torch.Tensor,
                 ins=(), scal=()):
    """Plain torch version of every kernel mode, in the operator's dtype."""
    raw = apply_trimmed(op.kband, op.ksum, op.mband, u, op.core == "mxu")
    return twin_epilogue(op, mode, raw, u, ins, scal)


def twin_epilogue(op, mode: str, raw: torch.Tensor, u: torch.Tensor, ins=(),
                  scal=()):
    """The mode's elementwise epilogue on raw = M A M u (the twins' half of
    laplace_epilogue in csrc/common.cuh)."""
    if mode == "apply":
        return (raw,)
    if mode == "residual1t":
        return (ins[0] - raw,)
    diag = op.diag_trimmed()
    if mode == "residual":
        r0 = ins[0] - raw
        return r0, r0 / (scal[0] * diag)
    if mode == "residual3t":
        r0 = ins[0] - raw
        d0 = r0 / (scal[0] * diag)
        return r0, d0, u + d0
    c0, c1 = scal
    r = ins[0]
    x = u if mode in ("chebd", "chebdl") else ins[1]
    rn = r - raw
    dn = c0 * u + (c1 / diag) * rn
    if mode in ("chebl", "chebdl"):
        return (x + dn,)
    return rn, dn, x + dn


def _check(op: CudaLaplaceOperator, t: torch.Tensor, what: str,
           dtype=None, shape=None) -> None:
    """t on the operator's device, of ``shape`` (the trimmed shape by
    default), contiguous and of ``dtype`` (the operator's by default)."""
    dtype = op.dtype if dtype is None else dtype
    shape = op.trimmed_shape if shape is None else tuple(shape)
    if t.device != op.device:
        raise ValueError(f"{what} on {t.device}, operator on {op.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what} has dtype {t.dtype}, expected {dtype} "
                         f"(operator {op.dtype})")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what} has shape {tuple(t.shape)}, "
                         f"expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _suffix(dtype) -> str:
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.float64:
        return "f64"
    raise ValueError(f"kernels take float32 or float64, not {dtype}")


def _launch(op: CudaLaplaceOperator, mode_index: int, u: torch.Tensor, ins,
            scal, out_dtypes, flags: int, key: str, out_shape=None,
            sizes=None):
    """Launch the operator's kernel in the mode of index ``mode_index`` on
    ``u``'s device; outputs of ``out_shape`` (u's shape by default), the
    grid's extents ``sizes`` (``op.kernel_sizes()`` by default)."""
    fn = op.kernel_fn()
    shape = u.shape if out_shape is None else out_shape
    outs = [torch.empty(shape, dtype=dt, device=u.device)
            for dt in out_dtypes]
    ptrs = [t.data_ptr() for t in ins] + [None] * (2 - len(ins))
    optrs = [t.data_ptr() for t in outs] + [None] * (3 - len(outs))
    c0, c1 = (list(map(float, scal)) + [0.0, 0.0])[:2]
    with torch.cuda.device(u.device):
        err = fn(u.data_ptr(), *ptrs, *optrs,
                 *(t.data_ptr() for t in op.kernel_state()),
                 *op.kernel_scalars(), c0, c1,
                 *(op.kernel_sizes() if sizes is None else sizes), op.degree,
                 mode_index, *op.tile, flags,
                 _build.stream_handle(u.device))
    if err:
        raise RuntimeError(f"{op.kernel} kernel ({key}) launch failed: "
                           f"CUDA error {err}")
    op.launches[key] = op.launches.get(key, 0) + 1
    return tuple(outs)


def row_sums(W1: np.ndarray, m1: np.ndarray) -> np.ndarray:
    """Row sums of the trimmed mask-folded (m W1 m)[:-1, :-1], from the
    entries the mask removes: the free rows of the assembled K, G and G^T
    sum to zero, so free row i sums to -sum_j W1[i, j] (1 - m_j), with no
    cancellation (constrained rows are zero)."""
    return (-m1 * (W1 @ (1.0 - m1)))[:-1]


def cuda_laplace_from_factors(degree: int, n: int, m1, K1, M1, gK, gM,
                              dtype=torch.float32, device="cpu",
                              cls=CudaLaplaceOperator,
                              core: str = "banded") -> CudaLaplaceOperator:
    """Pack the operator from its 1D factors (NumPy, float64): the free-DoF
    mask ``m1``, the assembled 1D matrices ``K1``/``M1`` and the diagonal
    factors ``gK`` (h-folded) / ``gM``, all of length n*degree + 1.
    ``cls`` is the operator class; its ``pick_tile`` chooses the launch
    tile.  ``core="mxu"`` (3D float32) rounds the bands to bf16 and takes
    K's row sums from the rounded bands."""
    if core not in CORES:
        raise ValueError(f"unknown core {core!r}; the port has {CORES}")
    if core == "mxu" and (dtype != torch.float32 or cls.dim != 3):
        raise ValueError("the mxu core is the 3D float32 bf16 grade")
    m1, K1, M1 = (np.asarray(a, np.float64) for a in (m1, K1, M1))
    Kt = (m1[:, None] * K1 * m1[None, :])[:-1, :-1]
    Mt = (m1[:, None] * M1 * m1[None, :])[:-1, :-1]
    t = functools.partial(to_tensor, dtype=dtype, device=device)
    kband, mband = to_bands(Kt, degree), to_bands(Mt, degree)
    ksum = row_sums(K1, m1)
    if core == "mxu":
        kband, mband = map(round_factors_bf16, (kband, mband))
        ksum = kband.sum(axis=0)
    itemsize = torch.empty((), dtype=dtype).element_size()
    return cls(
        degree=degree,
        n=n,
        mask1=t(m1),
        dK1=t(gK),
        dM1=t(gM),
        kband=t(kband),
        mband=t(mband),
        tile=cls.pick_tile(degree, itemsize, n * degree),
        ksum=t(ksum),
        core=core,
    )


def make_cuda_laplace(space: FESpace, dtype=torch.float32, device="cpu",
                      core: str = "banded") -> CudaLaplaceOperator:
    """Host packing (NumPy, f64) of the 1D factors, shipped once to
    ``device``; ``core="mxu"`` builds the bf16-grade recurrence operator
    (float32 only)."""
    if space.dim != 3:
        raise ValueError("B.1 is the 3D operator; make_cuda_laplace2d "
                         "builds the 2D one")
    K1, M1 = assembled_1d_matrices(space)
    gK, gM = diagonal_1d_factors(space)
    return cuda_laplace_from_factors(space.degree, space.mesh.cells_per_axis,
                                     space.free_mask_1d(), K1, M1, gK, gM,
                                     dtype, device, core=core)
