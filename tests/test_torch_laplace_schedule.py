"""B.1's x-marching plane schedule (``csrc/laplace.cu``), emulated on the
CPU, and its tile / chunk formula.

No CUDA kernel runs here, so the kernel's schedule is replayed in plain
torch, all blocks of the y-z plane at once: per x chunk of LX output planes
the input planes from x0 - p to x0 + LX + p, one iteration each plus one to
drain the pipeline.  ``load_plane(xn, b)`` fills the u window of xn (window
set (xn - xs) % 3; p halo rows in y and z, zeros off the grid), the
epilogue's inputs at x_o = xn - 1 - p (buffer b) and the x row of x_o (set
(xn - xs) % 3); iteration x_in issues the load of x_in + 1, then runs the z
stage of x_in into the z-product set of its parity, the y stage of x_in - 1
from the other set into ring slot (x_in - 1 - xs) % (2p+1), and the x stage
and epilogue at x_o = x_in - 1 - p, reading the ring from slot
(x_o - p - xs) % (2p+1).  Every K contraction in difference form with the
operator's ``ksum``.  The emulation must match ``laplace_twin`` to 1e-12
(float64) in all seven modes, with partial chunks, several y-z columns,
partial columns at the grid's edges, both dtypes' column heights and the
main path's 1-cell level (N = 4 at p = 4).  The untrimmed ``residual``
reads u and rhs on the full (N + 1)^3 grid at its strides, as the kernel's
guards let it: planes x <= N, rows y <= N, z < N, the Dirichlet plane and
row at zero weight; it must match the twin (which trims first) on fields
that are nonzero there.
"""

import numpy as np
import pytest
import torch
from test_torch_cheb2_schedule import _km, _rows, _take, _y

from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_laplace import (
    EZ,
    MODES,
    SMEM_LIMIT,
    laplace_tile,
    laplace_twin,
    make_cuda_laplace,
    march_smem_elems,
)

torch.set_num_threads(1)

SCAL = {"apply": (), "residual1t": (), "residual3t": (1.3,)}
INS = {"apply": (), "residual1t": ("r",), "residual3t": ("r",),
       "chebd": ("r",), "chebdl": ("r",)}


def epilogue(mode, raw, u, r, x, scal, diag):
    """laplace_epilogue of csrc/common.cuh on the values at the points."""
    if mode == "apply":
        return (raw,)
    if mode == "residual1t":
        return (r - raw,)
    if mode == "residual":
        r0 = r - raw
        return r0, r0 / (scal[0] * diag)
    if mode == "residual3t":
        r0 = r - raw
        d0 = r0 / (scal[0] * diag)
        return r0, d0, u + d0
    c0, c1 = scal
    x = u if mode in ("chebd", "chebdl") else x
    rn = r - raw
    dn = c0 * u + (c1 / diag) * rn
    return (x + dn,) if mode in ("chebl", "chebdl") else (rn, dn, x + dn)


def _take_full(f, xin, ry, rz):
    """_take on a full (N + 1)^3 field within the untrimmed residual's
    guards: x and y below N + 1, z below N."""
    n = f.shape[0]
    out_shape = (ry.shape[0], rz.shape[0], ry.shape[1], rz.shape[1])
    if not 0 <= xin < n:
        return torch.zeros(out_shape, dtype=f.dtype)
    ok = (((ry >= 0) & (ry < n))[:, None, :, None]
          & ((rz >= 0) & (rz < n - 1))[None, :, None, :])
    v = f[xin][ry.clamp(0, n - 1)[:, None, :, None],
               rz.clamp(0, n - 2)[None, :, None, :]]
    return v * ok


def schedule_emulation(op, mode, u, ins, scal, lx=None, ty=None):
    """B.1's outputs computed on the kernel's schedule (module docstring),
    all blocks of the y-z plane at once as a leading [nby, nbz]; ``lx`` and
    ``ty`` override the launch tile's chunk and column height.  In the
    untrimmed ``residual`` u and rhs are full-grid fields."""
    p = op.degree
    N = op.n * p
    take = _take_full if mode == "residual" else _take
    LX, TY, _ = op.tile
    LX, TY = lx or LX, ty or TY
    R, WY, WZ = 2 * p + 1, TY + 2 * p, EZ + 2 * p
    bands = (op.kband, op.mband)
    r_in = ins[0] if ins else None
    x_in = ins[1] if len(ins) > 1 else None
    dk, dm = op.dK1, op.dM1
    nby, nbz = -(-N // TY), -(-N // EZ)
    y0 = torch.arange(nby) * TY
    z0 = torch.arange(nbz) * EZ
    wy = y0[:, None] - p + torch.arange(WY)  # window rows
    wz = z0[:, None] - p + torch.arange(WZ)
    gy = y0[:, None] + torch.arange(TY)  # the column's points
    gz = z0[:, None] + torch.arange(EZ)
    # the bands of each lane's z row and of the column's y rows, broadcast
    # against [nby, nbz, rows, cols, taps]
    zk, zm, zs = (t[None, :, None] for t in _rows(bands, op.ksum, gz))
    yk, ym, ys = (t[:, None, :, None] for t in _rows(bands, op.ksum, gy))
    # the diagonal's y-z factors: diag = dK_x ay + dM_x by
    gyc, gzc = gy.clamp(0, N - 1), gz.clamp(0, N - 1)
    ay = dm[gyc][:, None, :, None] * dm[gzc][None, :, None, :]
    by = (dk[gyc][:, None, :, None] * dm[gzc][None, :, None, :]
          + dm[gyc][:, None, :, None] * dk[gzc][None, :, None, :])

    n_out = (3 if mode in ("residual3t", "cheb", "chebd") else
             2 if mode == "residual" else 1)
    outs = [torch.full((N,) * 3, float("nan"), dtype=u.dtype)
            for _ in range(n_out)]
    for x0 in range(0, N, LX):
        xend = min(x0 + LX, N)
        xs, xe = x0 - p, xend + p
        win, xrow, ebuf = [None] * 3, [None] * 3, [None] * 2
        zb, ring = [None] * 2, [None] * R

        def load_plane(xn, b):
            if xn < xe:
                win[(xn - xs) % 3] = take(u, xn, wy, wz)
            xo = xn - 1 - p
            if x0 <= xo < xend:
                ebuf[b] = (xo,) + tuple(
                    None if f is None else take(f, xo, gy, gz)
                    for f in (u, r_in, x_in))
                xrow[(xn - xs) % 3] = (xo,) + _rows(bands, op.ksum,
                                                    torch.tensor(xo))

        load_plane(xs, 0)
        for xin in range(xs, xe + 1):
            i, b = xin - xs, (xin - xs) & 1
            if xin < xe:
                load_plane(xin + 1, b ^ 1)
                zb[b] = _km(win[i % 3], zk, zm, zs)
            if xin == xs:
                continue
            ring[(i - 1) % R] = _y(zb[b ^ 1], yk, ym, ys)
            xo = xin - 1 - p
            if xo < x0:
                continue
            xx, k, m, s = xrow[i % 3]
            assert xx == xo and ebuf[b][0] == xo
            base = (xo - p - xs) % R
            mbc = ring[(base + p) % R][0]
            raw = s * mbc
            for o in range(R):
                mb_, s_ = ring[(base + o) % R]
                raw = raw + k[o] * (mb_ - mbc) + m[o] * s_
            diag = dk[xo] * ay + dm[xo] * by
            for out, v in zip(outs, epilogue(mode, raw, *ebuf[b][1:], scal,
                                             diag)):
                out[xo] = v.permute(0, 2, 1, 3).reshape(
                    nby * TY, nbz * EZ)[:N, :N]
    return tuple(outs)


# (p, r, lx, ty): N = 2^r p, the chunk not a divisor of N; the column
# heights of both tiles (24 rows in float32, 16 in float64).  p = 1 with
# two z columns and four y columns; p = 4 in one partial column and at the
# 1-cell level (N = 4); p = 7 in a partial z column over two y columns,
# the second partial; p = 3 with a partial second z column and two y
# columns
CASES = [(1, 6, 9, 16), (4, 2, 6, 24), (4, 0, 3, 16), (7, 2, 5, 24),
         (3, 4, 7, 24)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,r,lx,ty", CASES)
def test_schedule_matches_twin(p, r, lx, ty, mode):
    op = make_cuda_laplace(FESpace(HyperCubeMesh(3, r), p), torch.float64)
    N = op.n * p
    assert N % lx
    rng = np.random.default_rng(p)
    fields = {k: torch.as_tensor(rng.standard_normal((N,) * 3))
              for k in ("u", "r", "x")}
    ins = tuple(fields[k] for k in INS.get(mode, ("r", "x")))
    scal = SCAL.get(mode, (0.59, 1.26))
    want = laplace_twin(op, mode, fields["u"], ins, scal)
    got = schedule_emulation(op, mode, fields["u"], ins, scal, lx=lx, ty=ty)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        err = float((w - g).abs().max()) / float(w.abs().max())
        assert err <= 1e-12, err


@pytest.mark.parametrize("p,r,lx,ty", CASES)
def test_schedule_untrimmed_residual(p, r, lx, ty):
    """The untrimmed residual on the kernel's schedule from full-grid u
    and rhs, nonzero on the last planes, against the twin, 1e-12."""
    op = make_cuda_laplace(FESpace(HyperCubeMesh(3, r), p), torch.float64)
    rng = np.random.default_rng(p + 10)
    u, rhs = (torch.as_tensor(rng.standard_normal(op.grid_shape))
              for _ in range(2))
    want = op.twin("residual", u, (rhs,), (1.3,))
    got = schedule_emulation(op, "residual", u, (rhs,), (1.3,), lx=lx,
                             ty=ty)
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        err = float((w - g).abs().max()) / float(w.abs().max())
        assert err <= 1e-12, err


@pytest.mark.parametrize("p", range(1, 8))
def test_tile_fits_shared_memory(p):
    """The tile, ring and chunk formula for p = 1..7 in both dtypes: one
    block within 227 KB; 12 warps in float32 (168 registers a thread) and 8
    in float64, two rows of the column each; the chunk one of ceil(N / k)
    for k chunks."""
    for itemsize in (4, 8):
        for N in (2 * p, 8 * p, 64 * p):
            lx, ty, nw = laplace_tile(p, itemsize, N)
            assert march_smem_elems(p, ty) * itemsize <= SMEM_LIMIT
            assert nw == (12 if itemsize == 4 else 8)
            assert ty == 2 * nw
            assert 1 <= lx <= N and lx == -(-N // -(-N // lx))
    # one more row of the column: a window row (three buffers), a z-product
    # row of each set, a row of each ring plane and two sets of the three
    # epilogue inputs
    R = 2 * p + 1
    assert (march_smem_elems(p, 2) - march_smem_elems(p, 1)
            == 3 * (EZ + 2 * p) + 4 * EZ + R * 2 * EZ + 6 * EZ)


def test_chunks_of_the_main_path_levels():
    """LX at the seven levels of Q4 r=6 (trimmed 256^3 down to 4^3,
    float32, one block per SM over 88 columns at 256^3): 256^3 in 3 chunks,
    2 waves of 94 planes (not 1 of 264), 128^3 in one wave of 34, 64^3 in
    one of 11, the small levels in chunks of 2."""
    chunks = [laplace_tile(4, 4, 4 * 2 ** r)[0] for r in range(6, -1, -1)]
    assert chunks == [86, 26, 3, 2, 2, 2, 2]
