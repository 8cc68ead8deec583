"""B.5: the fused banded elasticity operator (``csrc/elasticity.cu``) and its
twin.

Counterpart of ``portable_multigrid_tpu/ops/pallas_elasticity.py``
(``PallasElasticityOperator``, ``make_pallas_elasticity``; the exact
"banded" core and the bf16 ``"mxu"`` core, with the structural x mask).
The operator works on TRIMMED 3-component state — [3, n p, n p, n p], the
global last plane of every spatial axis dropped, C order with z
contiguous — and computes M A M u for the 21 Kronecker chains of the
elasticity weak form (``ops/elasticity.py``) from the GLOBAL mask-folded
trimmed 1D matrices K, M, G and H = G^T, plus the single-step Chebyshev
epilogues of B.1 (modes in :data:`MODES`) with the per-component diagonal
diag_c = sum_k alpha_{k,c} (dK@k, dM elsewhere).

The TPU modes map to the port's: ``apply`` -> ``apply`` (trimmed in and
out; :meth:`~.cuda_laplace.CudaLaplaceOperator.apply` trims and pads around
it), ``residual1`` -> ``residual1t``, ``residual`` -> ``residual3t`` (which
also writes x0 = u + d0), ``cheb``/``chebl`` -> ``cheb``/``chebl``, and the
port's ``chebd``/``chebdl`` take x == d on entry.  The kernel sums every K,
G and H contraction in difference form with the row sums below; the twin
contracts the dense matrices directly.  On a CUDA tensor
:meth:`~.cuda_laplace.CudaLaplaceOperator.run` launches the kernel; on a
CPU tensor it runs :func:`elasticity_twin`.

``core="mxu"`` (float32 only) is the bf16 grade of the JAX package's
smoother recurrence (``pallas_elasticity.py:374-457``): the four bands
rounded to bf16 (their row sums taken from the rounded bands), u rounded
to bf16, each z product rounded, the y stage summed into the 12 (output c,
x matrix) groups with mu, lam and alpha folded in, each group rounded, and
the x stage, every product accumulated in float32.  Its twin is
:func:`elasticity_grouped` in that order.  The state stays float32: the
JAX kernel has no bf16 state, and neither has B.5 (``bf16_state``).  The
TPU core assembles x and y per block and rounds the two halves of a block
boundary entry apart; the global bands round the whole entry, so the two
agree at bf16 grade, not bit for bit.

The core picks the kernel instance: at ``core="mxu"`` the tensor-core
instance (``csrc/elasticitymma.cu``: the z and y stages as bf16
``mma.sync`` tiles with float accumulation, K, G and H summed directly;
the x stage and the epilogue on the CUDA cores) at every degree, with the
tile :func:`elasticity_mma_tile`; at the exact core, in float32 and
float64, and on the slab, the CUDA-core kernel (``csrc/elasticity.cu``).

While :func:`~..utils.profiling.tracing` is on, every pass of B.5 (the
kernel's launch on the card, its twin on the CPU) adds one to the counter
:func:`count_key` names, ``pmg.elasticity.<mode>/<core>.n<cells>``: the
mode (``apply/slab`` on a slab), the core (``mxu`` or ``exact``) and the
level's cells per axis, as ``pmg.elasticity.cheb/mxu.n64``.  The
recorder's ``counts`` keep it, and so do those of the V-cycle's active
:class:`~..utils.profiling.SpanPlan`: a graph captured under tracing keeps
the passes that each of its replays makes.  While tracing is off nothing
is counted there (:data:`LAUNCHES` counts the kernel's launches always).

:class:`CudaElasticitySlab` is the operator on one shard's slab of the
slab-sharded solve (the TPU kernel's ``make_pallas_elasticity_slab``,
``xmask="vector"``), in its one mode on that path, ``apply``, at its one
core, the exact one: x has factors of its own
(:func:`elasticity_partial_bands`), the input is x-full and the output
drops the slab's last plane, as B.1's slab (``ops/cuda_laplace.py``
``CudaLaplaceSlab``) does.
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
from .cuda_laplace import (
    CORES,
    MODES,
    SMEM_LIMIT,
    SMS,
    CudaLaplaceOperator,
    _check,
    _launch,
    chunk_planes,
    round_bf16,
    round_factors_bf16,
    row_sums,
    to_bands,
    twin_epilogue,
)
from .elasticity import (
    assembled_1d_gradient,
    elasticity_inv_diag,
    elasticity_kron,
    separable_elasticity_diagonal,
)
from .laplace import (
    assembled_1d_matrices,
    diagonal_1d_factors,
    separable_mask,
)
from .structured import contract

# kernel launches per mode, counted where the wrapper launches the kernel
LAUNCHES = dict.fromkeys(MODES, 0)

SMEM_BUDGET = 113 * 1024  # two blocks per SM
TZ = 32  # z extent of a block's column: one warp (kTZ in elasticity.cu)
_TY = (8, 4, 2, 1)  # candidate y extents; a block is 32 TY threads
_LX = (64, 48, 32, 16, 8, 4, 2)  # candidate x chunks (output planes a block)
_GROUPS = 12  # (output, x matrix) groups in the ring
COUNTER = "pmg.elasticity"  # the prefix of the pass counter's keys


def count_key(mode: str, core: str, n: int) -> str:
    """The pass counter's key of ``mode`` at ``core`` on a level of ``n``
    cells per axis."""
    return f"{COUNTER}.{mode}/{'mxu' if core == 'mxu' else 'exact'}.n{n}"


def elasticity_smem_elems(p: int, ty: int) -> int:
    """Shared-memory elements of one block (mirrors smem_elems in
    elasticity.cu): two windows of the three components, two sets of the
    four z products, and the ring of 2p+1 planes of 12 groups."""
    wy, wz = ty + 2 * p, TZ + 2 * p
    return 2 * 3 * wy * wz + 2 * 4 * wy * TZ + (2 * p + 1) * _GROUPS * ty * TZ


def elasticity_tile(p: int, itemsize: int, N: int,
                    nx: int | None = None) -> tuple[int, int, int]:
    """(LX, TY, TZ) of the launch for an N^3 grid (``nx`` output planes
    along x on a slab, N by default).

    TY: the largest that leaves room for two blocks per SM in float32 (the
    kernel's register bound assumes two), else the largest that fits one.
    LX: a block marches LX + 2p planes one after the other (the chunk and
    its lead-in), and the grid runs in waves of the blocks the SMs hold at
    once, so the chunk minimises waves x (LX + 2p), ties to the larger
    chunk: 64 at 3 x 192^3 (Q3 r=6), 2 on the small levels, where the
    march is the whole time of a launch."""
    limits = (SMEM_BUDGET, SMEM_LIMIT) if itemsize == 4 else (SMEM_LIMIT,)
    # at p >= 4 a block has at most 128 threads (kMaxThreads in the kernel)
    ty = next((t for limit in limits for t in _TY
               if elasticity_smem_elems(p, t) * itemsize <= limit
               and (p <= 3 or t <= 4)), None)
    if ty is None:
        raise ValueError(f"no elasticity tile fits shared memory at p={p}")
    two = itemsize == 4 and elasticity_smem_elems(p, ty) * 4 <= SMEM_BUDGET
    resident = SMS * (2 if two else 1)
    columns = -(-N // TZ) * -(-N // ty)
    nx = N if nx is None else nx

    def cost(lx):
        return -(-columns * -(-nx // lx) // resident) * (lx + 2 * p)

    return min(_LX, key=lambda lx: (cost(lx), -lx)), ty, TZ


# the tensor-core instance's tile (MmaTile in csrc/elasticitymma.cu)
_MMA_WS = 56  # bf16 row stride of the windows and the z band
SM_SMEM = 228 * 1024  # an H100 SM's shared memory, 1 KB of it a block's
MMA_THREADS_SM = 384  # threads an SM holds: 168 registers a thread


def _mma_rows(p: int, ty: int) -> dict:
    """The tensor-core tile's counts at ``ty`` rows (MmaTile in
    elasticitymma.cu): ty / 8 groups of 8 rows, two warps each (nw), the
    y stage's 8 + 2p taps padded to ky = 16 or 32 rows, the window's wyp =
    8 (groups - 1) + ky rows."""
    ng = ty // 8
    ky = 16 if 8 + 2 * p <= 16 else 32
    return dict(nw=2 * ng, nt=64 * ng, ky=ky, wyp=8 * (ng - 1) + ky)


def elasticity_mma_smem_bytes(p: int, ty: int) -> int:
    """Shared-memory bytes of one tensor-core block (MmaTile::smem_bytes in
    elasticitymma.cu): the x ring of 2p planes of each thread's three
    outputs at its 4 points (float4), three x columns of 2p+1 (K, M, G, H)
    float4 entries; in bf16 two windows of the three components (wyp rows
    of 56) and the z band of K, M, G, H (32 rows of 56 each)."""
    t = _mma_rows(p, ty)
    return (16 * (2 * p * 3 * t["nt"] + 3 * (2 * p + 1))
            + 2 * (2 * 3 * t["wyp"] * _MMA_WS + 4 * 32 * _MMA_WS))


def _mma_blocks(p: int, ty: int) -> int:
    """Blocks an SM holds: by shared memory and by MMA_THREADS_SM."""
    by_smem = SM_SMEM // (elasticity_mma_smem_bytes(p, ty) + 1024)
    return min(by_smem, MMA_THREADS_SM // _mma_rows(p, ty)["nt"])


@functools.cache
def _mma_ty(p: int) -> int | None:
    """TY of the tensor-core tile (mma_ty in elasticitymma.cu): of 32, 24,
    16 and 8 rows, the one whose blocks put the most warps on an SM, ties
    to the taller column; None where none fits."""
    fits = [ty for ty in (32, 24, 16, 8)
            if elasticity_mma_smem_bytes(p, ty) <= SMEM_LIMIT
            and _mma_blocks(p, ty) >= 1]
    if not fits:
        return None
    return max(fits, key=lambda ty: (_mma_blocks(p, ty)
                                     * _mma_rows(p, ty)["nw"], ty))


def elasticity_mma_tile(p: int, N: int) -> tuple[int, int, int]:
    """(LX, TY, NW) of a tensor-core launch for an N^3 grid: TY of
    :func:`_mma_ty` (24 rows, 6 warps, two blocks an SM at p <= 4; 32 rows,
    8 warps, one block above), two warps per 8-row group, and the chunk
    rule of :func:`~.cuda_laplace.chunk_planes` with 2p lead-in planes and
    the tile's blocks an SM: 39 planes at 3 x 192^3 (Q3 r=6, one wave of
    240 blocks), 2-4 on the lower levels, where the march is the whole
    time of a launch."""
    ty = _mma_ty(p)
    if ty is None:
        raise ValueError(f"no tensor-core elasticity tile fits at p={p}")
    columns = -(-N // TZ) * -(-N // ty)
    lx = chunk_planes(N, columns, 2 * p, _mma_blocks(p, ty))
    return lx, ty, _mma_rows(p, ty)["nw"]


@dataclasses.dataclass
class CudaElasticityOperator(CudaLaplaceOperator):
    """3D Q_p elasticity operator for the kernel path, on one device: the
    surface of the B.1 operator on [3, ...] fields, ``kband``/``mband`` plus
    the G and H bands, the row sums of K, G, H, and mu / lam; ``core``
    "banded" (exact) or "mxu" (the bf16 grade, float32)."""

    mu: float = 1.0
    lam: float = 1.0
    gband: torch.Tensor = None  # [2p+1, N-1] bands of the trimmed folded G
    hband: torch.Tensor = None  # [2p+1, N-1] bands of its transpose
    gsum: torch.Tensor = None  # ... of G
    hsum: torch.Tensor = None  # ... of G^T
    # [N-1, N-1] trimmed mask-folded K, M and G (twin)
    Kt: torch.Tensor = None
    Mt: torch.Tensor = None
    Gt: torch.Tensor = None
    kernel: ClassVar[str] = "pmg_elasticity"
    launches: ClassVar[dict] = LAUNCHES
    pair_kernel: ClassVar[bool] = False
    # B.5 stores every stream in its dtype, at either core
    bf16_state: ClassVar[bool] = False
    full_modes: ClassVar[tuple] = ()

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.dim,) + self.grid_shape

    @property
    def trimmed_shape(self) -> tuple[int, ...]:
        return (self.dim,) + (self.n * self.degree,) * self.dim

    @property
    def inv_diag(self) -> torch.Tensor:
        return elasticity_inv_diag(self)

    def diag_trimmed(self) -> torch.Tensor:
        """[3, ...] diagonal on the trimmed grid (raw values on constrained
        entries, as the kernel rebuilds it)."""
        return separable_elasticity_diagonal(self.dKt, self.dMt, self.mu,
                                             self.lam, self.dim)

    def pass_key(self, mode: str) -> str:
        """B.5's pass counter's key (:func:`count_key`)."""
        return count_key(mode, self.core, self.n)

    def kernel_fn(self):
        """``pmg_elasticitymma`` at the mxu core, else
        ``pmg_elasticity_f32``/``_f64``."""
        if self.core == "mxu":
            return _build.build().fn("pmg_elasticitymma")
        return super().kernel_fn()

    def raw_twin(self, mode: str, u: torch.Tensor, ins=(), scal=()):
        return elasticity_twin(self, mode, u, ins, scal)

    def kernel_state(self) -> tuple:
        """The y-z factors, then the x factors (on the cube the same
        ones)."""
        cube = (self.kband, self.ksum, self.mband, self.gband, self.gsum,
                self.hband, self.hsum, self.dK1, self.dM1)
        return cube * 2

    def kernel_scalars(self) -> tuple:
        return float(self.mu), float(self.lam)

    def kernel_sizes(self) -> tuple:
        """N, then the output and the input planes along x."""
        N = self.n * self.degree
        return N, N, N


@dataclasses.dataclass
class CudaElasticitySlab(CudaElasticityOperator):
    """B.5 on one shard's slab of the slab-sharded solve: the TPU kernel's
    ``make_pallas_elasticity_slab`` (``xmask="vector"``) in its one mode on
    that path, ``apply``, at the exact core.

    y and z are the cube's (N = n p trimmed points, the global factors);
    x has factors of its own: the bands of K, M, G and H = G^T assembled
    over the slab's ``n_loc`` cells with the shard's slice of the global x
    mask folded in, the row sums of K, G and H taken from those masked
    partial matrices (:func:`elasticity_partial_bands`), and the shard's
    slices of the global diagonal factors.  ``apply`` takes the x-FULL
    input, the shard's L = n_loc p trimmed planes of each component and
    its right neighbour's first plane, [3, L + 1, N, N], and writes the raw
    partial planes [3, L, N, N]: the slab's last plane, and the left
    neighbour's cells on plane 0, are the caller's
    (``parallel/sharding.py`` ``ShardedCudaElasticity``).  Float32 (the
    solve's) or float64."""

    n_loc: int = 0  # the slab's cells along x
    xkband: torch.Tensor = None  # [2p+1, L] bands of the masked partial K
    xksum: torch.Tensor = None  # [L] its row sums
    xmband: torch.Tensor = None  # [2p+1, L] bands of the masked partial M
    xgband: torch.Tensor = None  # [2p+1, L] ... of G
    xgsum: torch.Tensor = None  # [L] its row sums (-1 on an unmasked row 0)
    xhband: torch.Tensor = None  # [2p+1, L] ... of H = G^T
    xhsum: torch.Tensor = None  # [L] its row sums
    mask1x: torch.Tensor = None  # [L+1] the shard's slice of the x mask
    dK1x: torch.Tensor = None  # [L+1] ... of the stiffness diagonal factor
    dM1x: torch.Tensor = None  # [L+1] ... of the mass diagonal factor
    # [L, L+1] the masked partial K, M, G and H, rows 0 .. L-1 (twin)
    Kx: torch.Tensor = None
    Mx: torch.Tensor = None
    Gx: torch.Tensor = None
    Hx: torch.Tensor = None

    def __post_init__(self):
        if self.core == "mxu":
            raise ValueError("a B.5 slab runs at the exact core ('banded') "
                             "only")

    @property
    def grid_shape(self) -> tuple[int, ...]:
        """The full slab, shared planes included (one component)."""
        N = self.n * self.degree
        return self.n_loc * self.degree + 1, N + 1, N + 1

    @property
    def trimmed_shape(self) -> tuple[int, ...]:
        N = self.n * self.degree
        return 3, self.n_loc * self.degree, N, N

    @property
    def input_shape(self) -> tuple[int, ...]:
        """The x-full input: one plane more than the trimmed state."""
        _, L, N, _ = self.trimmed_shape
        return 3, L + 1, N, N

    @property
    def mask(self) -> torch.Tensor:
        return separable_mask((self.mask1x, self.mask1, self.mask1))

    @property
    def inv_diag(self) -> torch.Tensor:
        return elasticity_inv_diag(self, (self.dK1x, self.dK1, self.dK1),
                                   (self.dM1x, self.dM1, self.dM1))

    def diag_trimmed(self) -> torch.Tensor:
        L = self.trimmed_shape[1]
        return separable_elasticity_diagonal(
            (self.dK1x[:L], self.dKt, self.dKt),
            (self.dM1x[:L], self.dMt, self.dMt), self.mu, self.lam, 3)

    def run(self, mode: str, u: torch.Tensor, ins=(), scal=(), sdtype=None):
        """``apply`` on the x-full ``u``; returns (raw,)."""
        if mode != "apply":
            raise ValueError(f"unknown elasticity slab mode {mode!r}: a "
                             f"slab runs 'apply'")
        if ins or scal or sdtype not in (None, self.dtype):
            raise ValueError("a slab's apply takes u alone")
        _check(self, u, "u", shape=self.input_shape)
        if u.device.type == "cpu":
            outs = self.twin(mode, u)
        elif not u.is_cuda:
            raise ValueError(f"unsupported device {u.device}")
        else:
            outs = _launch(self, MODES.index("apply"), u, (), (),
                           (self.dtype,), 0, "apply/slab", self.trimmed_shape)
        if profiling.active() is not None:
            profiling.count(count_key("apply/slab", self.core, self.n))
        return outs

    def twin(self, mode: str, u: torch.Tensor, ins=(), scal=(), sdtype=None):
        """The dense partial x matrices and the global y-z ones contracted
        directly."""
        Gt = self.Gt
        return (elasticity_kron(u, (self.Kx, self.Kt, self.Kt),
                                (self.Mx, self.Mt, self.Mt),
                                (self.Gx, Gt, Gt), (self.Hx, Gt.T, Gt.T),
                                self.mu, self.lam),)

    def kernel_state(self) -> tuple:
        return ((self.kband, self.ksum, self.mband, self.gband, self.gsum,
                 self.hband, self.hsum, self.dK1, self.dM1)
                + (self.xkband, self.xksum, self.xmband, self.xgband,
                   self.xgsum, self.xhband, self.xhsum, self.dK1x,
                   self.dM1x))

    def kernel_sizes(self) -> tuple:
        _, L, N, _ = self.trimmed_shape
        return N, L, L + 1


def elasticity_partial_bands(m, K, M, G, degree: int) -> dict:
    """The x fields of a :class:`CudaElasticitySlab` (NumPy, by field
    name) from its partial 1D assembly ``K``, ``M``, ``G`` (float64, L + 1
    rows) with its slice ``m`` of the global mask folded in, over the first
    L rows: the bands of K, M, G and H = G^T, the row sums of K, G and H,
    and the dense [L, L + 1] matrices.
    The row sums come from the masked partial matrices themselves:
    :func:`~.cuda_laplace.row_sums` assumes that a free row sums to zero,
    which holds for K and H but not for the partial G, whose element rows
    sum to l_i(1) - l_i(0) (-1 on a slab's unmasked row 0)."""
    m, K, M, G = (np.asarray(a, np.float64) for a in (m, K, M, G))
    L = K.shape[0] - 1
    folded = {name: m[:, None] * W * m[None, :]
              for name, W in (("K", K), ("M", M), ("G", G), ("H", G.T))}
    out = {}
    for name, W in folded.items():
        out["x" + name.lower() + "band"] = to_bands(W, degree)[:, :L]
        if name != "M":
            out["x" + name.lower() + "sum"] = W.sum(axis=1)[:L]
        out[name + "x"] = W[:L]
    return out


def elasticity_twin(op: CudaElasticityOperator, mode: str, u: torch.Tensor,
                    ins=(), scal=()):
    """Plain torch version of every kernel mode (same inputs and outputs):
    the dense trimmed mask-folded 1D matrices contracted directly, at the
    mxu core in its grouped order and roundings."""
    if op.core == "mxu":
        raw = elasticity_grouped(u, op.Kt, op.Mt, op.Gt, op.mu, op.lam, True)
    else:
        raw = elasticity_kron(u, op.Kt, op.Mt, op.Gt, op.Gt.T, op.mu, op.lam)
    return twin_epilogue(op, mode, raw, u, ins, scal)


def elasticity_grouped(u: torch.Tensor, K, M, G, mu: float, lam: float,
                       bf16_grade: bool = False) -> torch.Tensor:
    """The 21 chains on a [3, N, N, N] field in B.5's order (the JAX core's,
    pallas_elasticity.py:374-457): K, M, G and H = G^T along z per
    component; along y the products that the 12 (output c, x matrix)
    groups take, summed with mu, lam and alpha = 2 mu + lam folded in;
    along x each group by its matrix.  ``bf16_grade`` rounds u, each z
    product and each group sum to bf16 (the mxu core's inputs of its
    three contractions); every contraction sums in u's dtype."""
    rnd = round_bf16 if bf16_grade else (lambda t: t)
    mats = {"k": K, "m": M, "g": G, "h": G.T}
    u = rnd(u)
    # z[a][Z]: Z along z of component a
    z = [{Z: rnd(contract(u[a], W, 2)) for Z, W in mats.items()}
         for a in range(3)]

    def y(a, name):
        """y matrix name[0] along y of the z product name[1] of a."""
        return contract(z[a][name[1]], mats[name[0]], 1)

    al = 2.0 * mu + lam
    groups = (  # per output c: its x matrix's group
        {"k": al * y(0, "mm"), "m": mu * (y(0, "km") + y(0, "mk")),
         "h": mu * (y(1, "gm") + y(2, "mg")),
         "g": lam * (y(1, "hm") + y(2, "mh"))},
        {"k": mu * y(1, "mm"),
         "m": al * y(1, "km") + mu * (y(1, "mk") + y(2, "hg"))
         + lam * y(2, "gh"),
         "g": mu * y(0, "hm"), "h": lam * y(0, "gm")},
        {"k": mu * y(2, "mm"),
         "m": mu * (y(2, "km") + y(1, "gh")) + al * y(2, "mk")
         + lam * y(1, "hg"),
         "g": mu * y(0, "mh"), "h": lam * y(0, "mg")},
    )
    return torch.stack([sum(contract(rnd(t), mats[X], 0)
                            for X, t in g.items()) for g in groups])


def cuda_elasticity_slab_from_factors(
        degree: int, n: int, n_loc: int, m1, K1, M1, G1, gK, gM, mu: float,
        lam: float, mx, Kx, Mx, Gx, gKx, gMx, dtype=torch.float32,
        device="cpu") -> CudaElasticitySlab:
    """Pack a slab's operator (NumPy, float64) at the exact core: the
    global 1D factors of y and z (``m1``, ``K1``, ``M1``, ``G1``, ``gK``,
    ``gM``, length n p + 1), and the slab's x factors: the shard's slices
    ``mx``, ``gKx``, ``gMx`` of the global mask and diagonal factors and
    the slab-partial assembly ``Kx``, ``Mx``, ``Gx`` over its n_loc cells,
    all of length n_loc p + 1 (:func:`elasticity_partial_bands`)."""
    cube = cuda_elasticity_from_factors(degree, n, m1, K1, M1, G1, gK, gM,
                                        mu, lam, dtype, device)
    x = elasticity_partial_bands(mx, Kx, Mx, Gx, degree)
    t = functools.partial(to_tensor, dtype=dtype, device=device)
    fields = {f.name: getattr(cube, f.name) for f in dataclasses.fields(cube)}
    itemsize = torch.empty((), dtype=dtype).element_size()
    fields["tile"] = elasticity_tile(degree, itemsize, n * degree,
                                     nx=n_loc * degree)
    return CudaElasticitySlab(
        **fields, n_loc=n_loc, mask1x=t(mx), dK1x=t(gKx), dM1x=t(gMx),
        **{k: t(v) for k, v in x.items()})


def cuda_elasticity_from_factors(degree: int, n: int, m1, K1, M1, G1, gK, gM,
                                 mu: float, lam: float, dtype=torch.float32,
                                 device="cpu",
                                 core: str = "banded") -> CudaElasticityOperator:
    """Pack the operator from its 1D factors (NumPy, float64): the free-DoF
    mask ``m1``, the assembled 1D matrices ``K1``/``M1``/``G1`` and the
    diagonal factors ``gK`` (h-folded) / ``gM``, all of length n*degree+1.
    ``core="mxu"`` (float32) rounds K, M and G to bf16 from float64 and
    takes the row sums from the rounded bands."""
    if core not in CORES:
        raise ValueError(f"unknown core {core!r}; the port has {CORES}")
    if core == "mxu" and dtype != torch.float32:
        raise ValueError("the mxu core is the float32 bf16 grade")
    m1, K1, M1, G1 = (np.asarray(a, np.float64) for a in (m1, K1, M1, G1))

    def fold(W):
        return (m1[:, None] * W * m1[None, :])[:-1, :-1]

    t = functools.partial(to_tensor, dtype=dtype, device=device)
    Kt, Mt, Gt = fold(K1), fold(M1), fold(G1)
    sums = row_sums(K1, m1), row_sums(G1, m1), row_sums(G1.T, m1)
    if core == "mxu":
        # a band holds the same entries as its matrix
        Kt, Mt, Gt = map(round_factors_bf16, (Kt, Mt, Gt))
        sums = tuple(to_bands(W, degree).sum(axis=0) for W in (Kt, Gt, Gt.T))
    itemsize = torch.empty((), dtype=dtype).element_size()
    N = n * degree
    tile = (elasticity_mma_tile(degree, N) if core == "mxu"
            else elasticity_tile(degree, itemsize, N))
    return CudaElasticityOperator(
        degree=degree, n=n, mask1=t(m1), dK1=t(gK), dM1=t(gM),
        kband=t(to_bands(Kt, degree)), mband=t(to_bands(Mt, degree)),
        tile=tile,
        Kt=t(Kt), Mt=t(Mt), mu=float(mu), lam=float(lam),
        gband=t(to_bands(Gt, degree)), hband=t(to_bands(Gt.T, degree)),
        ksum=t(sums[0]), gsum=t(sums[1]), hsum=t(sums[2]), Gt=t(Gt),
        core=core)


def make_cuda_elasticity(space: FESpace, dtype=torch.float32, mu: float = 1.0,
                         lam: float = 1.0, device="cpu",
                         core: str = "banded") -> CudaElasticityOperator:
    """Host packing (NumPy, f64) of the 1D factors, shipped once to
    ``device``; ``core="mxu"`` builds the bf16-grade recurrence operator
    (float32 only)."""
    if space.dim != 3:
        raise ValueError("B.5 is a 3D operator; the plain 'kron' "
                         "elasticity operator serves 2D")
    K1, M1 = assembled_1d_matrices(space)
    gK, gM = diagonal_1d_factors(space)
    return cuda_elasticity_from_factors(
        space.degree, space.mesh.cells_per_axis, space.free_mask_1d(), K1, M1,
        assembled_1d_gradient(space), gK, gM, mu, lam, dtype, device, core)
