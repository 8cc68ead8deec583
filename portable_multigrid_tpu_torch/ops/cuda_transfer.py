"""B.3: fused separable h-transfer (``csrc/transfer.cu``) and its twin.

Counterpart of ``portable_multigrid_tpu/ops/pallas_transfer.py``
(``PallasTransfer``, ``make_pallas_h_transfer``, ``_axis_matrix_1d``).
Between a trimmed fine level and its coarser neighbour

    P = Px (x) Py (x) Pz,    P_ax = diag(w_f m_f) E_ax diag(m_c)

trimmed to P_t = P[:-1, :-1]; restriction is the exact transpose.  The kernel
applies W (x) W (x) W for W = P_t (prolongation) or W = P_t^T (restriction),
with W in padded-row form; the twin contracts the dense W along each axis.
``coarse_trimmed=False`` pads or trims the (small) coarse side in the
wrapper, for the hand-off to the full-grid coarsest level.  Restriction runs
``restrict_kernel``, a march over the fine x planes, prolongation
``prolong_kernel``, a march over the coarse x planes.  A field with a
leading component axis (elasticity) is one launch, the component a grid
axis of the kernel; the twin contracts the last three axes.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import _build
from ..fem.basis import h_prolongation_matrix_1d
from ..fem.space import FESpace
from .cuda_laplace import SMEM_LIMIT, _suffix, chunk_planes
from .structured import contract
from .transfer import _weights_1d, pad_last_planes, trim_last_planes

MODES = ("restrict", "prolongate", "prolongate_and_add")
LAUNCHES = dict.fromkeys(MODES, 0)

# restrict_kernel's tile: a chunk of 16 coarse x rows and a coarse (8, 32)
# column of the y-z plane (kChunk, kRY, kRZ in transfer.cu)
RESTRICT_TILE = (16, 8, 32)
# prolong_kernel's fine (8, 32) column of the y-z plane and its
# coarse-plane buffers, PROLONG_STAGES - 1 planes ahead (kPY, kPZ, kPStages
# in transfer.cu)
PROLONG_COLUMN = (8, 32)
PROLONG_STAGES = 4


def prolong_blocks(itemsize: int, w: int) -> int:
    """Blocks of prolong_kernel an SM holds at once (kPBlocks in
    transfer.cu, the register cap of its launch bounds): in float32 4 (64
    registers a thread) for rows of w <= 5 taps and 3 (85) for wider
    ones, in float64 2 (128)."""
    if itemsize != 4:
        return 2
    return 4 if w <= 5 else 3


def _axis_matrix_1d(M1: np.ndarray, n_c: int, stride_c: int, stride_f: int,
                    wmask_f: np.ndarray, mask_c: np.ndarray) -> np.ndarray:
    """Full-grid 1D prolongation matrix [N_f, N_c] with weights and masks
    folded in — the split -> contract -> overlap-add -> weight schedule of
    ops/transfer.py as one matrix."""
    N_f = n_c * stride_f + 1
    N_c = n_c * stride_c + 1
    E = np.zeros((N_f, N_c))
    for c in range(n_c):
        E[c * stride_f: c * stride_f + stride_f + 1,
          c * stride_c: c * stride_c + stride_c + 1] += M1
    return wmask_f[:, None] * E * mask_c[None, :]


def padded_rows(W: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Row-wise padded form of a banded [n_out, n_in] matrix:
    (starts [n_out] int32, vals [n_out, w], w).  Row i's nonzeros lie in
    columns starts[i] .. starts[i]+w-1; starts are nondecreasing and keep
    every window inside [0, n_in)."""
    n_out, n_in = W.shape
    first = np.full(n_out, n_in)
    last = np.full(n_out, -1)
    for i in range(n_out):
        nz = np.flatnonzero(W[i])
        if nz.size:
            first[i], last[i] = nz[0], nz[-1]
    # suffix minimum: nondecreasing and never past a row's first nonzero
    # (rows through a coarse node can have a single nonzero far right)
    starts = np.minimum.accumulate(first[::-1])[::-1]
    w = max(1, int(np.max(last - starts + 1)))
    starts = np.clip(starts, 0, max(n_in - w, 0))
    vals = np.zeros((n_out, w))
    for i in range(n_out):
        vals[i] = W[i, starts[i]: starts[i] + w]
    if np.count_nonzero(vals) != np.count_nonzero(W):
        raise ValueError("padded rows do not cover the matrix")
    return starts.astype(np.int32), vals, w


def window_length(starts: np.ndarray, w: int, t: int) -> int:
    """Longest input window any tile of t output rows reaches."""
    n = len(starts)
    return max(int(starts[min(i + t, n) - 1] + w - starts[i])
               for i in range(0, n, t))


def restrict_smem_bytes(w: int, lens, itemsize: int) -> int:
    """Per-block shared memory of restrict_kernel (mirrors
    restrict_smem_elems in transfer.cu): two fine-plane windows, the z
    stage, the chunk's x rows, then their int starts."""
    chunk, _, tz = RESTRICT_TILE
    ly, lz = lens
    return (2 * ly * lz + ly * tz + chunk * w) * itemsize + chunk * 4


def prolong_smem_bytes(w: int, lx: int, lens, itemsize: int) -> int:
    """Per-block shared memory of prolong_kernel (mirrors
    prolong_smem_elems in transfer.cu): PROLONG_STAGES coarse-plane
    windows, the z stage, the chunk's LX rows of weights, then their int
    starts."""
    ly, lz = lens
    return ((PROLONG_STAGES * ly * lz + ly * PROLONG_COLUMN[1] + lx * w)
            * itemsize + lx * 4)


@functools.lru_cache(maxsize=None)
def prolong_chunk(n_out: int, w: int, count: int, itemsize: int) -> int:
    """Fine x rows LX of a prolong_kernel chunk for ``count`` components of
    n_out^3: a block marches about LX / 2 + w coarse planes, so the chunk
    minimises waves x (LX + 2w) over the grid's columns
    (:func:`~.cuda_laplace.chunk_planes`), :func:`prolong_blocks` an SM."""
    ty, tz = PROLONG_COLUMN
    columns = count * -(-n_out // ty) * -(-n_out // tz)
    return chunk_planes(n_out, columns, 2 * w, prolong_blocks(itemsize, w))


@dataclasses.dataclass
class _Direction:
    """One 1D matrix W (used on every axis) in both forms, with its launch
    geometry."""

    dense: torch.Tensor  # [n_out, n_in] for the twin
    starts: torch.Tensor  # [n_out] int32
    vals: torch.Tensor  # [n_out, w]
    w: int
    lens: tuple  # input extents (LY, LZ) a block's y-z column reaches
    restrict: bool  # restrict_kernel (W = P^T), else prolong_kernel (W = P)

    @property
    def n_out(self) -> int:
        return self.dense.shape[0]

    @property
    def n_in(self) -> int:
        return self.dense.shape[1]


def _direction(W: np.ndarray, dtype, device, restrict: bool) -> _Direction:
    starts, vals, w = padded_rows(W)
    itemsize = torch.empty((), dtype=dtype).element_size()
    column = RESTRICT_TILE[1:] if restrict else PROLONG_COLUMN
    lens = tuple(window_length(starts, w, t) for t in column)
    # a prolongation chunk has at most every output row
    nbytes = (restrict_smem_bytes(w, lens, itemsize) if restrict
              else prolong_smem_bytes(w, len(starts), lens, itemsize))
    if nbytes > SMEM_LIMIT:
        raise ValueError("no transfer tile fits shared memory")
    return _Direction(
        dense=torch.as_tensor(W, dtype=dtype, device=device),
        starts=torch.as_tensor(starts, device=device),
        vals=torch.as_tensor(vals, dtype=dtype, device=device),
        w=w, lens=lens, restrict=restrict)


def transfer_twin(W: torch.Tensor, src: torch.Tensor, add=None) -> torch.Tensor:
    """Plain torch (W (x) W (x) W) src (+ add) on the last three axes."""
    t = contract(contract(contract(src, W, -3), W, -2), W, -1)
    return t if add is None else t + add


@dataclasses.dataclass
class CudaTransfer:
    """Fused h-transfer between a trimmed fine level and its coarser
    neighbour (trimmed, or full when ``coarse_trimmed`` is False)."""

    prolong: _Direction
    restrict_: _Direction
    coarse_trimmed: bool

    def _run(self, mode: str, W: _Direction, src, add=None):
        if src.device.type == "cpu":
            return transfer_twin(W.dense, src, add)
        if not src.is_cuda:
            raise ValueError(f"unsupported device {src.device}")
        n_in, n_out = W.n_in, W.n_out
        lead = tuple(src.shape[:-3])  # (3,) for a vector field
        for name, t, n in (("input", src, n_in), ("addend", add, n_out)):
            if t is None:
                continue
            if t.device != W.dense.device or t.dtype != W.dense.dtype:
                raise ValueError(f"{name}: {t.dtype} on {t.device}, transfer "
                                 f"{W.dense.dtype} on {W.dense.device}")
            want = lead + (n,) * 3
            if tuple(t.shape) != want or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous {want} "
                                 f"tensor, got {tuple(t.shape)}")
        lib = _build.build()
        out = torch.empty(lead + (n_out,) * 3, dtype=src.dtype,
                          device=src.device)
        count = int(np.prod(lead))  # components: a grid axis of the kernel
        stream = _build.stream_handle(src.device)
        if W.restrict:
            err = lib.fn("pmg_restrict", _suffix(src.dtype))(
                src.data_ptr(), out.data_ptr(), W.starts.data_ptr(),
                W.vals.data_ptr(), W.w, n_in, n_out, count, *W.lens, stream)
        else:
            err = lib.fn("pmg_prolong", _suffix(src.dtype))(
                src.data_ptr(), None if add is None else add.data_ptr(),
                out.data_ptr(), W.starts.data_ptr(), W.vals.data_ptr(), W.w,
                n_in, n_out, count,
                prolong_chunk(n_out, W.w, count, src.element_size()),
                *W.lens, stream)
        if err:
            raise RuntimeError(f"transfer kernel ({mode}) launch failed: "
                               f"CUDA error {err}")
        LAUNCHES[mode] += 1
        return out

    def restrict(self, f: torch.Tensor) -> torch.Tensor:
        c = self._run("restrict", self.restrict_, f)
        return c if self.coarse_trimmed else pad_last_planes(c, 3)

    def _coarse_in(self, c: torch.Tensor) -> torch.Tensor:
        return (c if self.coarse_trimmed
                else trim_last_planes(c, 3).contiguous())

    def prolongate(self, c: torch.Tensor) -> torch.Tensor:
        return self._run("prolongate", self.prolong, self._coarse_in(c))

    def prolongate_and_add(self, dst: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        """dst + P c with the addition fused into the kernel's output tiles."""
        return self._run("prolongate_and_add", self.prolong,
                         self._coarse_in(c), add=dst)


def cuda_transfer_from_matrix(P: np.ndarray, dtype=torch.float32, device="cpu",
                              coarse_trimmed: bool = True) -> CudaTransfer:
    """Build from the full-grid 1D prolongation matrix [N_f, N_c] with
    weights and masks folded in (:func:`_axis_matrix_1d`)."""
    P_t = np.asarray(P, np.float64)[:-1, :-1]  # trimmed: last planes dropped
    return CudaTransfer(
        prolong=_direction(P_t, dtype, device, restrict=False),
        restrict_=_direction(np.ascontiguousarray(P_t.T), dtype, device,
                             restrict=True),
        coarse_trimmed=coarse_trimmed,
    )


def make_cuda_h_transfer(coarse: FESpace, fine: FESpace, dtype=torch.float32,
                         device="cpu", coarse_trimmed: bool = True) -> CudaTransfer:
    if fine.dim != 3 or coarse.degree != fine.degree:
        raise ValueError("the kernel transfer is a 3D equal-degree h-transfer")
    if fine.mesh.cells_per_axis != 2 * coarse.mesh.cells_per_axis:
        raise ValueError("fine mesh must be one refinement of the coarse mesh")
    p = fine.degree
    n_c = coarse.mesh.cells_per_axis
    w = _weights_1d(n_c, 2 * p) * fine.free_mask_1d()
    P = _axis_matrix_1d(h_prolongation_matrix_1d(p), n_c, p, 2 * p, w,
                        coarse.free_mask_1d())
    return cuda_transfer_from_matrix(P, dtype, device, coarse_trimmed)
