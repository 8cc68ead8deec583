"""B.2's x-marching two-ring schedule (``csrc/cheb2.cu``), emulated on the
CPU, and its tile / ring / chunk formula.

No CUDA kernel runs here, so the kernel's schedule is replayed in plain
torch, all blocks of the y-z plane at once: per x chunk of LX output planes
the input planes from x0 - 2p to x0 + LX + 2p, one iteration each plus two
to drain the pipeline.  Iteration x_in runs step two of d1 plane
x1 = x_in - 2 - p (its y stage into ring 2, slot (x1 - x0 + p) % (2p+1),
and once d1 plane x2 + p is in, the x stage and epilogue at x2 = x1 - p);
step one's z stage of the d window of x_in (2p halo in y and z, zeros off
the grid) into the z-product set of its parity; step one's y stage of plane x_in - 1 from the other set into
ring 1 (slot (x_in - 1 - xs) % (2p+1)), its x stage and epilogue at
x1 = x_in - 1 - p with the interior (r1, d1) into the lag ring (slot
(x1 - x0 + p) % (p+1)), and step two's z stage of that d1 plane into the
set of x1's parity.  Every K contraction in difference form with the
operator's ``ksum``.  The cheb2f0 modes run as chebd2 on the pre-pass's
d0 = b / (theta diag) and r = b.  The emulation must match
``cheb2_twin`` to 1e-12 (float64) in all six modes, with partial chunks,
several y-z columns and partial columns at the grid's edges.
"""

import numpy as np
import pytest
import torch

from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_cheb2 import (
    EZ,
    MODES,
    cheb2_smem_elems,
    cheb2_tile,
    cheb2_twin,
    make_cheb2,
)
from portable_multigrid_tpu_torch.ops.cuda_laplace import (
    SMEM_LIMIT,
    make_cuda_laplace,
)

torch.set_num_threads(1)

SCAL = (0.59, 1.26, 0.71, 1.52)
THETA = 1.3


def _rows(bands, ksum, g):
    """K and M coefficients [..., 2p+1] and K's row sum of rows g (zeros
    for rows off the grid)."""
    kb, mb = bands
    N = kb.shape[1]
    ok = (g >= 0) & (g < N)
    gc = g.clamp(0, N - 1)
    k = kb[:, gc].movedim(0, -1) * ok[..., None]
    m = mb[:, gc].movedim(0, -1) * ok[..., None]
    return k, m, ksum[gc] * ok


def _take(f, xin, ry, rz):
    """f[xin, ry, rz] for row sets ry [nby, A], rz [nbz, B] ->
    [nby, nbz, A, B], zeros off the grid."""
    N = f.shape[0]
    out_shape = (ry.shape[0], rz.shape[0], ry.shape[1], rz.shape[1])
    if not 0 <= xin < N:
        return torch.zeros(out_shape, dtype=f.dtype)
    ok = (((ry >= 0) & (ry < N))[:, None, :, None]
          & ((rz >= 0) & (rz < N))[None, :, None, :])
    v = f[xin][ry.clamp(0, N - 1)[:, None, :, None],
               rz.clamp(0, N - 1)[None, :, None, :]]
    return v * ok


def _km(u, k, m, s):
    """K (difference form) and M along the last axis of u, at the taps'
    centres; k, m [..., taps] and s broadcast against the output."""
    p = (k.shape[-1] - 1) // 2
    U = u.unfold(-1, 2 * p + 1, 1)
    uc = U[..., p:p + 1]
    return s * uc[..., 0] + (k * (U - uc)).sum(-1), (m * U).sum(-1)


def _y(zb, k, m, s):
    """The y stage of a z-product pair zb = (Kz u, Mz u) [nby, nbz, rows,
    cols]: My Mz u and Ky Mz u (difference form) + My Kz u at the centres
    of the row taps."""
    p = (k.shape[-1] - 1) // 2
    A, B = (t.unfold(2, 2 * p + 1, 1) for t in zb)
    bc = B[..., p:p + 1]
    return ((m * B).sum(-1),
            s * bc[..., 0] + (k * (B - bc)).sum(-1) + (m * A).sum(-1))


def schedule_emulation(kern, d, r, x, scal, mode, lx=None):
    """B.2's outputs computed on the kernel's schedule (module docstring),
    all blocks of the y-z plane at once as a leading [nby, nbz]."""
    op = kern.op
    p = op.degree
    N = op.n * p
    LX, TY, _ = kern.tile
    LX = LX if lx is None else lx
    R, TZ, EY = 2 * p + 1, EZ - 2 * p, TY + 2 * p
    WY, WZ = TY + 4 * p, EZ + 2 * p
    bands = (op.kband, op.mband)
    if mode.startswith("cheb2f0"):
        # the pre-pass: chebd2* on d0 = b / (theta diag) and r = b
        d, r = d / (scal[4] * op.diag_trimmed()), d
        mode = mode.replace("cheb2f0", "chebd2")
    last = mode.endswith("l")
    c0a, c1a, c0b, c1b = scal[:4]
    dk, dm = op.dK1, op.dM1
    nby, nbz = -(-N // TY), -(-N // TZ)
    y0 = torch.arange(nby) * TY
    z0 = torch.arange(nbz) * TZ
    wy = y0[:, None] - 2 * p + torch.arange(WY)  # window rows
    wz = z0[:, None] - 2 * p + torch.arange(WZ)
    gy = y0[:, None] - p + torch.arange(EY)  # grown column
    gz = z0[:, None] - p + torch.arange(EZ)
    iy, iz = gy[:, p:p + TY], gz[:, p:EZ - p]  # interior
    # the bands of each lane's z row and of the grown y rows, broadcast
    # against [nby, nbz, rows, cols, taps]
    zk, zm, zs = (t[None, :, None] for t in _rows(bands, op.ksum, gz))
    yk, ym, ys = (t[:, None, :, None] for t in _rows(bands, op.ksum, gy))
    zin = tuple(t[:, :, :, p:EZ - p] for t in (zk, zm, zs))
    yin = tuple(t[:, :, p:p + TY] for t in (yk, ym, ys))
    grown_in = (((gy >= 0) & (gy < N))[:, None, :, None]
                & ((gz >= 0) & (gz < N))[None, :, None, :])

    def diag(xx, ry, rz):
        ky_, my_ = (v[ry.clamp(0, N - 1)][:, None, :, None] for v in (dk, dm))
        kz_, mz_ = (v[rz.clamp(0, N - 1)][None, :, None, :] for v in (dk, dm))
        return dk[xx] * my_ * mz_ + dm[xx] * (ky_ * mz_ + my_ * kz_)

    def x_stage(ring, base, xx):
        k, m, s = _rows(bands, op.ksum, torch.tensor(xx))
        mbc = ring[(base + p) % R][0]
        raw = s * mbc
        for o in range(R):
            mb_, s_ = ring[(base + o) % R]
            raw = raw + k[o] * (mb_ - mbc) + m[o] * s_
        return raw

    outs = [torch.full_like(d, float("nan")) for _ in range(1 if last else 3)]
    for x0 in range(0, N, LX):
        xend = min(x0 + LX, N)
        xs, xe = x0 - 2 * p, xend + 2 * p
        ring1, ring2, lag = [None] * R, [None] * R, [None] * (p + 1)
        zb1, zb2 = [None, None], [None, None]  # z products by parity
        for xin in range(xs, xe + 2):
            i = xin - xs
            # step two of d1 plane x1 = xin - 2 - p (z stage done last
            # iteration): y stage into ring 2; x stage and epilogue at x2
            x1 = xin - 2 - p
            x2 = x1 - p
            if x0 - p <= x1 < xend + p:
                ring2[(x1 - x0 + p) % R] = _y(zb2[x1 & 1], *yin)
                if x0 <= x2 < xend:
                    raw = x_stage(ring2, (x2 - x0) % R, x2)
                    r1, d1 = lag[(x2 - x0 + p) % (p + 1)]
                    dg = diag(x2, iy, iz)
                    r2 = r1 - raw
                    d2 = c0b * d1 + (c1b / dg) * r2
                    xv = _take(x if mode in ("cheb2", "cheb2l") else d, x2,
                               iy, iz)
                    x2v = xv + d1 + d2
                    for o, v in zip(outs, (x2v,) if last else (r2, d2, x2v)):
                        o[x2] = v.permute(0, 2, 1, 3).reshape(
                            nby * TY, nbz * TZ)[:N, :N]
            # step one's z stage of input plane xin
            if xin < xe:
                zb1[i & 1] = _km(_take(d, xin, wy, wz), zk, zm, zs)
            # step one's y stage of plane xin - 1, its x stage at x1
            if not xs <= xin - 1 < xe:
                continue
            ring1[(i - 1) % R] = _y(zb1[(i - 1) & 1], yk, ym, ys)
            x1 = xin - 1 - p
            if x1 < x0 - p:
                continue
            if 0 <= x1 < N:
                raw1 = x_stage(ring1, (x1 - p - xs) % R, x1)
                dg = diag(x1, gy, gz)
                rE, dE = (_take(f, x1, gy, gz) for f in (r, d))
                zero = torch.zeros_like(raw1)
                r1 = torch.where(grown_in, rE - raw1, zero)
                d1 = torch.where(grown_in, c0a * dE + (c1a / dg) * r1, zero)
            else:
                r1 = d1 = torch.zeros(nby, nbz, EY, EZ, dtype=d.dtype)
            lag[(x1 - x0 + p) % (p + 1)] = (r1[:, :, p:p + TY, p:EZ - p],
                                            d1[:, :, p:p + TY, p:EZ - p])
            # step two's z stage of the d1 plane on the interior lanes
            zb2[x1 & 1] = _km(d1, *zin)
    return tuple(outs)


def _kernel(p, r):
    op = make_cuda_laplace(FESpace(HyperCubeMesh(3, r), p), torch.float64)
    return make_cheb2(op)


# (p, r, lx): N = 2^r p not a multiple of the chunk; p = 1 and p = 4 with
# two y-z columns in z (the second partial) and four in y, p = 7 with one
# partial z column and seven y columns of two rows
CASES = [(1, 5, 5), (4, 3, 6), (7, 1, 4)]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,r,lx", CASES)
def test_schedule_matches_twin(p, r, lx, mode):
    kern = _kernel(p, r)
    N = kern.op.n * p
    assert N % lx
    rng = np.random.default_rng(p)
    d, r_, x = (torch.as_tensor(rng.standard_normal((N,) * 3))
                for _ in range(3))
    f0 = mode.startswith("cheb2f0")
    args = (d, None if f0 else r_, x if mode in ("cheb2", "cheb2l") else None,
            SCAL + ((THETA,) if f0 else ()))
    want = cheb2_twin(kern.op, *args, mode)
    got = schedule_emulation(kern, *args, mode, lx=lx)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        err = float((w - g).abs().max()) / float(w.abs().max())
        assert err <= 1e-12, err


@pytest.mark.parametrize("p", range(1, 8))
def test_tile_fits_shared_memory(p):
    """The tile, ring and chunk formula for p = 1..7 in both dtypes: one
    block within 227 KB; whole warps, two grown rows each, at most 12 in
    float32 (168 registers a thread) and 8 in float64; at p <= 4 in
    float32 the 16 interior rows of the main path's tile; the chunk one of
    ceil(N / k) for k chunks."""
    for itemsize in (4, 8):
        for N in (2 * p, 8 * p, 64 * p):
            lx, ty, nw = cheb2_tile(p, itemsize, N)
            assert cheb2_smem_elems(p, ty) * itemsize <= SMEM_LIMIT
            assert nw == -(-(ty + 2 * p) // 2) >= ty / 2
            assert nw <= (12 if itemsize == 4 else 8)
            if itemsize == 4 and p <= 4:
                assert ty == 16
            assert 1 <= lx <= N and lx == -(-N // -(-N // lx))
    # one more interior row: a window row (three buffers), two z-product
    # rows of step one (two sets), a grown row in ring 1, the d1 plane,
    # step two's z products (two sets) and the r, d buffers; an interior
    # row in ring 2, the lag ring and the x buffer
    R = 2 * p + 1
    assert (cheb2_smem_elems(p, 2) - cheb2_smem_elems(p, 1)
            == 3 * (EZ + 2 * p) + 4 * EZ + R * 2 * EZ + EZ + 4 * EZ
            + 4 * EZ + R * 2 * EZ + (p + 1) * 2 * EZ + 2 * EZ)


def test_chunks_of_the_main_path_levels():
    """LX at the six smoothing levels of Q4 r=6 (trimmed 256^3 down to
    8^3, float32, one block per SM): 256^3 in 3 chunks, 4 waves of 102
    planes (not 3 of 144 in 2 chunks), 128^3 in one wave of 80, 64^3 in
    one of 22 (11 chunks), the small levels in one wave of 18 planes."""
    chunks = [cheb2_tile(4, 4, 4 * 2 ** r)[0] for r in range(6, 0, -1)]
    assert chunks == [86, 64, 6, 2, 2, 2]


@pytest.mark.parametrize("p,r", [(1, 3), (4, 2), (7, 2)])
def test_k_row_sums_are_those_of_the_folded_stiffness(p, r):
    op = make_cuda_laplace(FESpace(HyperCubeMesh(3, r), p), torch.float64)
    N = op.n * p
    Kt = torch.zeros(N, N, dtype=torch.float64)
    for o in range(-p, p + 1):
        i = torch.arange(max(0, -o), min(N, N - o))
        Kt[i, i + o] = op.kband[p + o, i]
    scale = float(op.kband.abs().max())
    assert float((Kt.sum(1) - op.ksum).abs().max()) <= 1e-13 * scale
    assert float(op.ksum[p + 1:N - p].abs().max()) == 0.0
