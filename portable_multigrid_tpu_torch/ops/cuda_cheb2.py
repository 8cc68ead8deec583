"""B.2: two Chebyshev steps per pass (``csrc/cheb2.cu``) and its twin.

Counterpart of ``portable_multigrid_tpu/ops/pallas_cheb2.py``
(``Cheb2Kernel.steps2`` / ``make_cheb2`` at ``exact=True`` grade).  On
trimmed state:

    r1 = r  - M A M d      d1 = c0a d  + (c1a / diag) r1
    r2 = r1 - M A M d1     d2 = c0b d1 + (c1b / diag) r2
    x2 = x + d1 + d2

Modes (:data:`MODES`): ``cheb2`` in (d, r, x) out (r2, d2, x2); ``cheb2l``
out x2 only; ``chebd2``/``chebd2l`` take x == d; ``cheb2f0``/``cheb2f0l``
start from the rhs b passed in the d slot (d0 = b / (theta diag), r0 = b,
x0 = d0; theta is scal[4]).  The kernel shares the operator's band arrays
and diagonal factors (:class:`~.cuda_laplace.CudaLaplaceOperator`).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import _build
from .cuda_laplace import (
    SMEM_LIMIT,
    CudaLaplaceOperator,
    _check,
    _suffix,
    apply_trimmed,
)

MODES = ("cheb2", "cheb2l", "chebd2", "chebd2l", "cheb2f0", "cheb2f0l")
LAUNCHES = dict.fromkeys(MODES, 0)

_TILES = ((8, 8, 32), (8, 8, 16), (8, 8, 8), (4, 4, 8))
# tile of the global-workspace path (shapes whose windows fit no block)
_WORKSPACE_TILE = (8, 8, 8)


def cheb2_smem_elems(p: int, tx: int, ty: int, tz: int) -> int:
    """Per-block buffer elements (mirrors smem_elems in cheb2.cu)."""
    dx, dy, dz = tx + 4 * p, ty + 4 * p, tz + 4 * p
    ex, ey, ez = tx + 2 * p, ty + 2 * p, tz + 2 * p
    b0 = max(dx * dy * dz, 2 * dx * ey * ez, 2 * ex * ey * tz + 2 * ex * ty * tz)
    return b0 + max(2 * dx * dy * ez, 2 * ex * ey * ez)


def cheb2_tile(p: int, itemsize: int) -> tuple[tuple[int, int, int], bool]:
    """(tile, in_shared_memory): the largest candidate whose buffers fit a
    block's shared memory, else the workspace tile."""
    for tile in _TILES:
        if cheb2_smem_elems(p, *tile) * itemsize <= SMEM_LIMIT:
            return tile, True
    return _WORKSPACE_TILE, False


@dataclasses.dataclass
class Cheb2Kernel:
    """Two-step fused recurrence on the operator ``op``'s level."""

    op: CudaLaplaceOperator
    tile: tuple
    in_smem: bool

    def steps2(self, d, r, x, scal, mode: str = "cheb2"):
        """One pass of ``mode``; returns (r2, d2, x2) or (x2,) for "l" modes."""
        if mode not in MODES:
            raise ValueError(f"unknown cheb2 mode {mode!r}")
        from_rhs = mode in ("cheb2f0", "cheb2f0l")
        if (r is None) != from_rhs:
            raise ValueError(f"mode {mode!r}: r must be given iff not from rhs")
        if (x is None) != (mode not in ("cheb2", "cheb2l")):
            raise ValueError(f"mode {mode!r}: x must be given iff cheb2/cheb2l")
        if len(scal) != (5 if from_rhs else 4):
            raise ValueError(f"mode {mode!r}: wrong number of scalars")
        if d.device.type == "cpu":
            return cheb2_twin(self.op, d, r, x, scal, mode)
        if not d.is_cuda:
            raise ValueError(f"unsupported device {d.device}")
        return self._launch(d, r, x, scal, mode)

    def _launch(self, d, r, x, scal, mode):
        op = self.op
        _check(op, d, "d")
        for name, t in (("r", r), ("x", x)):
            if t is not None:
                _check(op, t, name)
        fn = _build.build().fn("pmg_cheb2", _suffix(d.dtype))
        last = mode.endswith("l")
        outs = [torch.empty_like(d) for _ in range(1 if last else 3)]
        optrs = [t.data_ptr() for t in outs] + [None] * (3 - len(outs))
        N = op.n * op.degree
        workspace = None
        if not self.in_smem:
            nblocks = 1
            for t in self.tile:
                nblocks *= -(-N // t)
            workspace = torch.empty(
                nblocks * cheb2_smem_elems(op.degree, *self.tile),
                dtype=d.dtype, device=d.device)
        sc = [float(s) for s in scal] + [0.0] * (5 - len(scal))
        err = fn(d.data_ptr(), None if r is None else r.data_ptr(),
                 None if x is None else x.data_ptr(), *optrs,
                 op.kband.data_ptr(), op.mband.data_ptr(), op.dK1.data_ptr(),
                 op.dM1.data_ptr(), *sc, N, op.degree, MODES.index(mode),
                 *self.tile, None if workspace is None else workspace.data_ptr(),
                 _build.stream_handle(d.device))
        if err:
            raise RuntimeError(f"cheb2 kernel ({mode}) launch failed: "
                               f"CUDA error {err}")
        LAUNCHES[mode] += 1
        return tuple(outs)


def cheb2_twin(op: CudaLaplaceOperator, d, r, x, scal, mode: str):
    """Plain torch version of every pair mode (same inputs and outputs)."""
    c0a, c1a, c0b, c1b = scal[:4]
    diag = op.diag_trimmed()
    if mode in ("cheb2f0", "cheb2f0l"):
        r = d
        d = r / (scal[4] * diag)
        x = d
    elif mode in ("chebd2", "chebd2l"):
        x = d
    r1 = r - apply_trimmed(op.Kt, op.Mt, d)
    d1 = c0a * d + (c1a / diag) * r1
    r2 = r1 - apply_trimmed(op.Kt, op.Mt, d1)
    d2 = c0b * d1 + (c1b / diag) * r2
    x2 = x + d1 + d2
    if mode.endswith("l"):
        return (x2,)
    return r2, d2, x2


def make_cheb2(op: CudaLaplaceOperator) -> Cheb2Kernel:
    if op.dim != 3:
        # as in the JAX package (pallas_cheb2.py:59-69)
        raise ValueError("the pair kernel B.2 is 3D only")
    itemsize = torch.empty((), dtype=op.dtype).element_size()
    tile, in_smem = cheb2_tile(op.degree, itemsize)
    return Cheb2Kernel(op=op, tile=tile, in_smem=in_smem)
