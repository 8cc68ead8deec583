"""B.4's x-marching row schedule (``csrc/laplace2d.cu``), emulated on the
CPU, and its tile / chunk formula.

No CUDA kernel runs here, so the kernel's schedule is replayed in plain
torch, all y columns of a chunk at once: per x chunk of LX output rows the
input rows from x0 - p to x0 + LX + p - 1, one iteration each.
``load_row(i)`` fills buffer set i % STAGES with the u row x_in = x0 - p + i
(TY + 2p values, zeros off the grid) and, at an output row x_o = x_in - p,
its x row and the epilogue's inputs; the pipeline issues STAGES - 1 rows
ahead, so iteration i first loads row i + STAGES - 1 into the set row i - 1
used.  Iteration i shifts the ring of 2p+1 (My u, Ky u) pairs by one slot,
runs the y stage of row i into its newest slot 2p, then the x stage at x_o
from slots o = 0..2p (input rows i - 2p + o) and the epilogue.  Every K
contraction in difference form with the operator's ``ksum``.  The
emulation must match ``laplace2d_twin`` to 1e-12 (float64) in all seven
modes, with several chunks (the last partial), several y columns and a
partial column.
"""

import numpy as np
import pytest
import torch
from test_torch_cheb2_schedule import _km, _rows
from test_torch_laplace_schedule import INS, SCAL, epilogue

from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_laplace import MODES, SMEM_LIMIT
from portable_multigrid_tpu_torch.ops.cuda_laplace2d import (
    NW,
    STAGES,
    laplace2d_blocks,
    laplace2d_smem_elems,
    laplace2d_tile,
    laplace2d_twin,
    make_cuda_laplace2d,
)

torch.set_num_threads(1)


def _row(f, x, ry):
    """f[x, ry] for a row set ry [nby, A], zeros off the grid."""
    N = f.shape[0]
    if not 0 <= x < N:
        return torch.zeros(ry.shape, dtype=f.dtype)
    return f[x][ry.clamp(0, N - 1)] * ((ry >= 0) & (ry < N))


def schedule_emulation(op, mode, u, ins, scal, lx=None, ty=None):
    """B.4's outputs computed on the kernel's schedule (module docstring),
    all columns at once as a leading [nby]; ``lx`` and ``ty`` override the
    launch tile's chunk and column height."""
    p = op.degree
    N = op.n * p
    LX, TY, _ = op.tile
    LX, TY = lx or LX, ty or TY
    R, WY, ahead = 2 * p + 1, TY + 2 * p, STAGES - 1
    bands = (op.kband, op.mband)
    r_in = ins[0] if ins else None
    x_in = ins[1] if len(ins) > 1 else None
    dk, dm = op.dK1, op.dM1
    nby = -(-N // TY)
    y0 = torch.arange(nby) * TY
    wy = y0[:, None] - p + torch.arange(WY)  # the u row with its halo
    gy = y0[:, None] + torch.arange(TY)  # the threads' points
    yk, ym, ys = _rows(bands, op.ksum, gy)
    ok = gy < N
    dky, dmy = (v[gy.clamp(0, N - 1)] * ok for v in (dk, dm))

    n_out = 3 if mode in ("residual3t", "cheb", "chebd") else 1
    outs = [torch.full_like(u, float("nan")) for _ in range(n_out)]
    for x0 in range(0, N, LX):
        xend = min(x0 + LX, N)
        rows = xend - x0 + 2 * p
        stage, ring = [None] * STAGES, [None] * R

        def load_row(i):
            if i >= rows:
                return
            xin = x0 - p + i
            xo = xin - p
            xrow = ebuf = None
            if xo >= x0:
                xrow = _rows(bands, op.ksum, torch.tensor(xo)) + (dk[xo],
                                                                   dm[xo])
                ebuf = tuple(None if f is None else _row(f, xo, gy)
                             for f in (u, r_in, x_in))
            stage[i % STAGES] = (i, _row(u, xin, wy), xrow, ebuf)

        for j in range(ahead):
            load_row(j)
        for i in range(rows):
            load_row(i + ahead)  # into the set row i - 1 used
            ii, urow, xrow, ebuf = stage[i % STAGES]
            assert ii == i
            ka, mb = _km(urow, yk, ym, ys)  # Ky u, My u at the points
            ring = ring[1:] + [(mb, ka)]
            if i < 2 * p:
                continue
            xo = x0 - 2 * p + i
            k, m, s, dkx, dmx = xrow
            mbc = ring[p][0]
            rk, rm = s * mbc, 0.0
            for o in range(R):
                mb_o, ka_o = ring[o]
                rk = rk + k[o] * (mb_o - mbc)
                rm = rm + m[o] * ka_o
            diag = dkx * dmy + dmx * dky
            for out, v in zip(outs, epilogue(mode, rk + rm, *ebuf, scal,
                                             diag)):
                out[xo] = v.reshape(nby * TY)[:N]
    return tuple(outs)


# (p, r, lx, ty): N = 2^r p, the chunk not a divisor of N, several y
# columns with the last one partial.  p = 1: N = 64 in 10 chunks of 7 over
# three columns of 24; p = 3: N = 24 in 5 chunks of 5 over two columns of
# 16; p = 4: N = 32 in 3 chunks of 12 over one partial column of the
# launch's height; p = 7: N = 28 in 3 chunks of 11 over two columns of 16
CASES = [(1, 6, 7, 24), (3, 3, 5, 16), (4, 3, 12, None), (7, 2, 11, 16)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,r,lx,ty", CASES)
def test_schedule_matches_twin(p, r, lx, ty, mode):
    op = make_cuda_laplace2d(FESpace(HyperCubeMesh(2, r), p), torch.float64)
    N = op.n * p
    assert N % lx and N % (ty or op.tile[1])
    rng = np.random.default_rng(p)
    fields = {k: torch.as_tensor(rng.standard_normal((N, N)))
              for k in ("u", "r", "x")}
    ins = tuple(fields[k] for k in INS.get(mode, ("r", "x")))
    scal = SCAL.get(mode, (0.59, 1.26))
    want = laplace2d_twin(op, mode, fields["u"], ins, scal)
    got = schedule_emulation(op, mode, fields["u"], ins, scal, lx=lx, ty=ty)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        err = float((w - g).abs().max()) / float(w.abs().max())
        assert err <= 1e-12, err


@pytest.mark.parametrize("p", range(1, 8))
def test_tile_fits_shared_memory(p):
    """The tile and chunk formula for p = 1..7 in both dtypes: the blocks
    an SM holds within its shared memory, one y point a thread, the chunk
    one of ceil(N / k) for k chunks."""
    for itemsize in (4, 8):
        blocks = laplace2d_blocks(itemsize)
        for N in (2 * p, 8 * p, 512 * p):
            lx, ty, nw = laplace2d_tile(p, itemsize, N)
            assert (nw, ty) == (NW, 32 * NW)
            assert blocks * laplace2d_smem_elems(p, ty) * itemsize <= SMEM_LIMIT
            assert 1 <= lx <= N and lx == -(-N // -(-N // lx))
    # one more y point of the column: a u-row value (rounded up to four)
    # and the three epilogue inputs, in each buffer set
    assert (laplace2d_smem_elems(p, 132) - laplace2d_smem_elems(p, 128)
            == STAGES * (4 + 3 * 4))


def test_chunks_of_the_ladder_levels():
    """LX at the seven levels of the 2D Q7 r=9 ladder, (512 p)^2, p = 1..7,
    in float32: every level fills the card in one wave of at most 528
    blocks (4 an SM), with 2p lead-in rows a chunk; the p = 1 coarse level
    (512^2, the coarse solve's 511 launches) in 512 blocks of 6 rows."""
    chunks = [laplace2d_tile(p, 4, 512 * p)[0] for p in range(1, 8)]
    assert chunks == [4, 16, 35, 63, 99, 140, 200]
    for p, lx in zip(range(1, 8), chunks):
        N = 512 * p
        blocks = -(-N // (32 * NW)) * -(-N // lx)
        assert blocks <= 132 * laplace2d_blocks(4) < 2 * blocks
