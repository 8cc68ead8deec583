"""B.2's ``cheb2lr`` (the last pre-smoothing pair and the V-cycle's residual
in one pass, ``PMG_CHEB2R=1``) against the JAX package, on the CPU.

* the port's twin of ``cheb2lr`` against JAX's ``make_cheb2(...,
  rout=True)`` run in interpret mode (``zpad=0``), as its own tests run it:
  at the exact grade (``exact=True``; float32 state) within 1e-6 of
  max|out|, and at the production grade (bf16 matrices, bf16 d and r)
  within 8e-3, the bound of the pair's production test
  (tests/test_torch_bf16_cheb2.py);
* ``FusedChebyshev.smooth_and_residual`` against ``smooth`` then
  ``residual`` at the exact grade in float64, to 1e-12
  (tests/test_pallas_cheb2.py:151-209; in float32 the residual formed
  incrementally differs from the one formed afresh by ~2e-6 of its
  largest value), and its fallback where the recurrence does not pair
  up;
* the switches ``PMG_CHEB2`` and ``PMG_CHEB2R`` of the Poisson levels;
* the float32 ``MixedPrecisionPoisson(3, 4, 2)`` solve with
  ``PMG_CHEB2R=1``: its CG count within one of the default's, and equal to
  the JAX package's count of the construction of
  tests/test_pallas_cheb2.py:211-258 (run in a child process, ~45 s,
  started when the module starts);
* the kernel's three-stage x-march (``csrc/cheb2.cuh``, ROUT), emulated in
  plain torch, against the twin, and its tile formula.

Inputs are made with numpy from a seed; every ``PMG_*`` setting is pinned.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.ops.pallas_cheb2 import make_cheb2 as jmake_cheb2
from portable_multigrid_tpu_torch import GeometricMultigridPoisson
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.models.mixed import MixedPrecisionPoisson
from portable_multigrid_tpu_torch.ops.cuda_cheb2 import (
    EZ,
    Cheb2RKernel,
    cheb2_fits,
    cheb2_smem_elems,
    cheb2_tile,
    cheb2_twin,
    make_cheb2,
)
from portable_multigrid_tpu_torch.ops.cuda_laplace import (
    SMEM_LIMIT,
    make_cuda_laplace,
)
from portable_multigrid_tpu_torch.solvers.chebyshev import FusedChebyshev
from test_torch_cheb2_schedule import _km, _rows, _take, _y

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCAL = (0.59, 1.26, 0.71, 1.52)
# the JAX package's test of the trade-off, as a child process: the count
# of the float32 MixedPrecisionPoisson(3, 4, 2) solve whose finest level
# runs the production pairs and the cheb2lr kernel in interpret mode
_CHILD = """
import json
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from portable_multigrid_tpu.models.mixed import MixedPrecisionPoisson
from portable_multigrid_tpu.ops.pallas_cheb2 import make_cheb2
from portable_multigrid_tpu.ops.pallas_laplace import make_pallas_laplace
from portable_multigrid_tpu.solvers.chebyshev import FusedChebyshev
from portable_multigrid_tpu.solvers.vcycle import MGLevel, wire_trimmed
prob = MixedPrecisionPoisson(3, 4, 2, mg_dtype=jnp.float32)
sp = prob.spaces[-1]
kw = dict(bx=4, by=4, interpret=True)
exact = make_pallas_laplace(sp, jnp.float32, **kw)
mxu = make_pallas_laplace(sp, jnp.float32, core="mxu", **kw)
k2 = make_cheb2(sp, jnp.float32, **kw)
k2r = make_cheb2(sp, jnp.float32, rout=True, **kw)
lv = list(prob.levels)
sm = FusedChebyshev(degree=lv[-1].smoother.degree, op=exact, op_smooth=mxu,
                    op_cheb2=k2, op_cheb2r=k2r, theta=lv[-1].smoother.theta,
                    delta=lv[-1].smoother.delta, trimmed_io=True,
                    state_dtype="bf16")
lv[-1] = MGLevel(op=exact, smoother=sm, transfer=lv[-1].transfer)
prob.levels, prob.fine_trimmed = wire_trimmed(lv)
prob.levels = tuple(prob.levels)
_, st = prob.solve()
print(json.dumps(dict(iterations=st.iterations, converged=st.converged,
                      l2=st.solution_l2_norm)))
"""


@pytest.fixture(scope="module", autouse=True)
def _pmg_defaults():
    """Every PMG_* setting of both packages at its default."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("PMG_")]:
            mp.delenv(key)
        yield


@pytest.fixture(scope="module")
def jax_rout_solve():
    """The JAX solve of the child process, started when the module
    starts (the module's first test asks for it)."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("PMG_")}
    proc = subprocess.Popen([sys.executable, "-c", _CHILD], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_child_started(jax_rout_solve):
    assert jax_rout_solve.poll() in (None, 0)


def _masked(N, rng):
    v = rng.standard_normal((N,) * 3).astype(np.float32)
    v[0], v[:, 0], v[:, :, 0] = 0.0, 0.0, 0.0
    return v


def _rel(want, got):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    return np.abs(want - got).max() / np.abs(want).max()


# (p, r, block): 2 x 2 blocks of the JAX kernel (the rout windows' halo,
# 3p = 6, within a block of 8 rows) and one block at the main path's degree
@pytest.mark.parametrize("p,r,b", [(2, 3, 4), (4, 2, 4)])
@pytest.mark.parametrize("grade", ["exact", "production"])
def test_cheb2lr_matches_jax(grade, p, r, b):
    exact = grade == "exact"
    jk = jmake_cheb2(JSpace(JMesh(3, r), p), jnp.float32, bx=b, by=b, zpad=0,
                     interpret=True, exact=exact, rout=True)
    op = make_cuda_laplace(FESpace(HyperCubeMesh(3, r), p), torch.float32,
                           core="banded" if exact else "mxu")
    kern = make_cheb2(op, rout=True)
    N = (2 ** r) * p
    rng = np.random.default_rng(p + r)
    d, r_, x = (_masked(N, rng) for _ in range(3))
    if exact:
        jd, jr = jnp.asarray(d), jnp.asarray(r_)
        td, tr, sd = torch.from_numpy(d), torch.from_numpy(r_), None
    else:
        jd, jr = jnp.asarray(d, jnp.bfloat16), jnp.asarray(r_, jnp.bfloat16)
        td, tr = (torch.from_numpy(np.array(v.astype(jnp.float32)))
                  .to(torch.bfloat16) for v in (jd, jr))
        sd = torch.bfloat16
    want = jk.steps2(jd, jr, jnp.asarray(x), np.asarray(SCAL, np.float32),
                     "cheb2lr", sdtype="f32" if exact else "bf16")
    got = kern.steps2(td, tr, torch.from_numpy(x), SCAL, "cheb2lr",
                      sdtype=sd)
    assert len(got) == len(want) == 2
    bound = 1e-6 if exact else 8e-3
    for w, g in zip(want, got):
        assert g.dtype == torch.float32 and w.dtype == jnp.float32
        assert _rel(w, g.numpy()) <= bound


def _smoothers(p, r, degree, rout=True, dtype=torch.float64):
    op = make_cuda_laplace(FESpace(HyperCubeMesh(3, r), p), dtype)
    kw = dict(degree=degree, op=op, theta=1.3, delta=0.9,
              op_cheb2=make_cheb2(op))
    fused = FusedChebyshev(**kw, op_cheb2r=make_cheb2(op, rout=True)
                           if rout else None)
    return op, FusedChebyshev(**kw), fused


# (p, r, degree): two pairs at the main path's degree 5; one pair only
@pytest.mark.parametrize("p,r,degree", [(2, 3, 5), (3, 2, 5), (2, 2, 3)])
def test_smooth_and_residual_equals_smooth_then_residual(p, r, degree):
    op, base, fused = _smoothers(p, r, degree)
    N = (2 ** r) * p
    rng = np.random.default_rng(7)
    b, u = (torch.from_numpy(_masked(N, rng)).double() for _ in range(2))
    ua = base.smooth(u, b)
    ra = base.residual(ua, b)
    ub, rb = fused.smooth_and_residual(u, b)
    assert _rel(ua, ub) <= 1e-12
    assert _rel(ra, rb) <= 1e-12


def test_smooth_and_residual_falls_back():
    """Without a cheb2lr kernel, or with an odd number of steps, it is
    smooth then residual, bit for bit."""
    N = 16
    rng = np.random.default_rng(9)
    b, u = (torch.from_numpy(_masked(N, rng)) for _ in range(2))
    for degree, rout in ((5, False), (4, True)):
        _, base, sm = _smoothers(2, 3, degree, rout, torch.float32)
        un, rn = sm.smooth_and_residual(u, b)
        u0 = base.smooth(u, b)
        assert torch.equal(un, u0)
        assert torch.equal(rn, base.residual(u0, b))


def test_rout_kernel_takes_cheb2lr_only():
    op = make_cuda_laplace(FESpace(HyperCubeMesh(3, 1), 2), torch.float32)
    d = torch.zeros(op.trimmed_shape)
    with pytest.raises(ValueError, match="cheb2lr"):
        make_cheb2(op, rout=True).steps2(d, d, d, SCAL, "cheb2l")
    with pytest.raises(ValueError, match="cheb2lr"):
        make_cheb2(op).steps2(d, d, d, SCAL, "cheb2lr")


@pytest.mark.parametrize("env,pairs,rout", [({}, True, False),
                                            ({"PMG_CHEB2": "0"}, False, False),
                                            ({"PMG_CHEB2R": "1"}, True, True)])
def test_poisson_switches(monkeypatch, env, pairs, rout):
    """PMG_CHEB2 (default "1") and PMG_CHEB2R (default "0") of the JAX
    package's Poisson levels: without pairs the single steps run on B.1's
    mxu core; cheb2lr is built from the pairs' operator."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    prob = GeometricMultigridPoisson(3, 2, 2, torch.float32, "auto", "cpu")
    for lvl in prob.levels[1:]:
        sm = lvl.smoother
        assert sm.op_smooth.core == "mxu"
        assert (sm.op_cheb2 is not None) == pairs
        assert (sm.op_cheb2r is not None) == rout
        if rout:
            assert isinstance(sm.op_cheb2r, Cheb2RKernel)
            assert sm.op_cheb2r.op is sm.op_smooth
    _, st = prob.solve(rtol=1e-5)
    assert st.converged


def test_cheb2r_skips_levels_without_a_tile(monkeypatch):
    """At p = 6 no cheb2lr tile fits one block in float32: that level
    builds no cheb2lr kernel and runs smooth then residual."""
    monkeypatch.setenv("PMG_CHEB2R", "1")
    prob = GeometricMultigridPoisson(3, 6, 1, torch.float32, "auto", "cpu")
    sm = prob.levels[-1].smoother
    assert sm.op_cheb2 is not None and sm.op_cheb2r is None
    assert not cheb2_fits(sm.op_smooth, rout=True)
    with pytest.raises(ValueError, match="cheb2lr tile"):
        make_cheb2(sm.op_smooth, rout=True)


@pytest.mark.parametrize("p", range(1, 8))
def test_rout_tile(p):
    """cheb2lr's tile: p <= 5 in float32 and p <= 3 in float64 fit one
    block (two grown rows a warp, step one's column grown by 2p), the
    others are refused; a block of 12 warps (8 in float64) at most, TZ =
    32 - 4p interior lanes, chunks with 6p lead-in planes."""
    for itemsize, top in ((4, 5), (8, 3)):
        for N in (2 * p, 64 * p):
            if p > top:
                with pytest.raises(ValueError):
                    cheb2_tile(p, itemsize, N, rout=True)
                continue
            lx, ty, nw = cheb2_tile(p, itemsize, N, rout=True)
            assert cheb2_smem_elems(p, ty, 3) * itemsize <= SMEM_LIMIT
            assert nw == -(-(ty + 4 * p) // 2) <= (12 if itemsize == 4 else 8)
            assert 1 <= lx <= N
    # the main path's degree: 8 interior rows of 16 lanes
    assert cheb2_tile(4, 4, 256, rout=True)[1:] == (8, 12)
    # one more interior row: step one's rows in the windows, both z-product
    # sets, ring 1, the d1 plane, step two's z products and the r, d
    # buffers; step two's in ring 2 and the lag ring; the d2 plane, step
    # three's z products, ring 3, the r2 lag ring and the x buffer
    R = 2 * p + 1
    assert (cheb2_smem_elems(p, 2, 3) - cheb2_smem_elems(p, 1, 3)
            == 3 * (EZ + 2 * p) + 4 * EZ + R * 2 * EZ + EZ + 4 * EZ
            + 4 * EZ + R * 2 * EZ + (p + 1) * 2 * EZ + EZ + 4 * EZ
            + R * 2 * EZ + (p + 1) * EZ + 2 * EZ)


def rout_schedule_emulation(op, d, r, x, scal, ty, lx):
    """cheb2lr computed on the kernel's schedule (csrc/cheb2.cuh, ROUT), all
    blocks of the y-z plane at once as a leading [nby, nbz].  A block owns
    TY x (32 - 4p) outputs; step one runs on the column grown by 2p, step
    two on the column grown by p, step three on the interior.  Per x chunk
    the input planes run from x0 - 3p to xend + 3p, one iteration each
    plus three to drain: iteration xin runs step three of d2 plane
    xd = xin - 3 - 2p (y stage into ring 3; r_out at x3 = xd - p from the
    r2 lag ring), step two of d1 plane x1 = xin - 2 - p (y stage into ring
    2; r2, d2 at x2 = x1 - p on its column, zero off the grid, x2 and the
    r2 lag on the interior, step three's z stage of d2), step one's z
    stage of the d window of xin (3p halo), and step one's y stage of
    plane xin - 1 into ring 1, its x stage at xin - 1 - p with (r1, d1)
    into the lag ring on step two's column and step two's z stage of d1.
    Ring slots: the plane less xs; lag slots: the plane less x0 plus 2p,
    modulo p + 1."""
    p = op.degree
    N = op.n * p
    R, G = 2 * p + 1, 2 * p
    TZ, EY, E2 = EZ - 2 * G, ty + 2 * G, ty + 2 * p
    WY, WZ = ty + 2 * G + 2 * p, EZ + 2 * p
    bands, dk, dm = (op.kband, op.mband), op.dK1, op.dM1
    c0a, c1a, c0b, c1b = scal
    nby, nbz = -(-N // ty), -(-N // TZ)
    y0 = torch.arange(nby) * ty
    z0 = torch.arange(nbz) * TZ
    wy = y0[:, None] - G - p + torch.arange(WY)  # window rows
    wz = z0[:, None] - G - p + torch.arange(WZ)
    gy = y0[:, None] - G + torch.arange(EY)  # step one's column
    gz = z0[:, None] - G + torch.arange(EZ)
    gy2, gz2 = gy[:, p:p + E2], gz[:, p:EZ - p]  # step two's
    iy, iz = gy[:, G:G + ty], gz[:, G:EZ - G]  # the interior
    zk, zm, zs = (t[None, :, None] for t in _rows(bands, op.ksum, gz))
    yk, ym, ys = (t[:, None, :, None] for t in _rows(bands, op.ksum, gy))
    z2 = tuple(t[:, :, :, p:EZ - p] for t in (zk, zm, zs))
    z3 = tuple(t[:, :, :, G:EZ - G] for t in (zk, zm, zs))
    y2 = tuple(t[:, :, p:p + E2] for t in (yk, ym, ys))
    y3 = tuple(t[:, :, G:G + ty] for t in (yk, ym, ys))

    def inside(ry, rz):
        return (((ry >= 0) & (ry < N))[:, None, :, None]
                & ((rz >= 0) & (rz < N))[None, :, None, :])

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

    def put(out, xx, v):
        out[xx] = v.permute(0, 2, 1, 3).reshape(nby * ty, nbz * TZ)[:N, :N]

    x2out, rout = (torch.full_like(d, float("nan")) for _ in range(2))
    for x0 in range(0, N, lx):
        xend = min(x0 + lx, N)
        xs, xe = x0 - G - p, xend + G + p
        ring1, ring2, ring3 = [None] * R, [None] * R, [None] * R
        lag1, lag2 = [None] * (p + 1), [None] * (p + 1)
        zb1, zb2, zb3 = [None, None], [None, None], [None, None]
        for xin in range(xs, xe + 3):
            i = xin - xs
            xd = xin - 3 - 2 * p
            x3 = xd - p
            if x0 - p <= xd < xend + p:
                ring3[(xd - xs) % R] = _y(zb3[xd & 1], *y3)
                if x0 <= x3 < xend:
                    raw = x_stage(ring3, (x3 - p - xs) % R, x3)
                    put(rout, x3, lag2[(x3 - x0 + G) % (p + 1)] - raw)
            x1 = xin - 2 - p
            x2 = x1 - p
            if x0 - G <= x1 < xend + G:
                ring2[(x1 - xs) % R] = _y(zb2[x1 & 1], *y2)
                if x0 - p <= x2 < xend + p:
                    r2 = d2 = torch.zeros(nby, nbz, E2, EZ - 2 * p,
                                          dtype=d.dtype)
                    if 0 <= x2 < N:
                        raw = x_stage(ring2, (x2 - p - xs) % R, x2)
                        r1, d1 = lag1[(x2 - x0 + G) % (p + 1)]
                        ok = inside(gy2, gz2)
                        r2 = torch.where(ok, r1 - raw, r2)
                        d2 = torch.where(
                            ok, c0b * d1 + (c1b / diag(x2, gy2, gz2)) * r2,
                            d2)
                    if x0 <= x2 < xend:
                        interior = (slice(None), slice(None),
                                    slice(p, p + ty), slice(p, EZ - 3 * p))
                        put(x2out, x2, _take(x, x2, iy, iz) + d1[interior]
                            + d2[interior])
                        lag2[(x2 - x0 + G) % (p + 1)] = r2[interior]
                    zb3[x2 & 1] = _km(d2, *z3)
            if xin < xe:
                zb1[i & 1] = _km(_take(d, xin, wy, wz), zk, zm, zs)
            if not xs <= xin - 1 < xe:
                continue
            ring1[(i - 1) % R] = _y(zb1[(i - 1) & 1], yk, ym, ys)
            x1 = xin - 1 - p
            if x1 < x0 - G:
                continue
            r1 = d1 = torch.zeros(nby, nbz, EY, EZ, dtype=d.dtype)
            if 0 <= x1 < N:
                raw = x_stage(ring1, (x1 - p - xs) % R, x1)
                ok = inside(gy, gz)
                rE, dE = (_take(f, x1, gy, gz) for f in (r, d))
                r1 = torch.where(ok, rE - raw, r1)
                d1 = torch.where(ok, c0a * dE + (c1a / diag(x1, gy, gz)) * r1,
                                 d1)
            lag1[(x1 - x0 + G) % (p + 1)] = (r1[:, :, p:p + E2, p:EZ - p],
                                             d1[:, :, p:p + E2, p:EZ - p])
            zb2[x1 & 1] = _km(d1, *z2)
    return x2out, rout


# (p, r, lx): N not a multiple of the chunk; two y-z columns in z at p = 1
# (the second partial) and p = 4 (16 lanes), five y columns of four rows
# at p = 5 with a partial z column
@pytest.mark.parametrize("p,r,lx", [(1, 5, 5), (4, 3, 6), (5, 2, 7)])
def test_rout_schedule_matches_twin(p, r, lx):
    op = make_cuda_laplace(FESpace(HyperCubeMesh(3, r), p), torch.float64)
    N = op.n * p
    assert N % lx
    ty = cheb2_tile(p, 4, N, rout=True)[1]  # the float32 tile
    rng = np.random.default_rng(p)
    d, r_, x = (torch.as_tensor(rng.standard_normal((N,) * 3))
                for _ in range(3))
    want = cheb2_twin(op, d, r_, x, SCAL, "cheb2lr")
    got = rout_schedule_emulation(op, d, r_, x, SCAL, ty, lx)
    for w, g in zip(want, got):
        err = float((w - g).abs().max()) / float(w.abs().max())
        assert err <= 1e-12, err


def test_cheb2r_costs_at_most_one_iteration(monkeypatch, jax_rout_solve):
    """The float32 config-5 solve at Q4 r=2 with PMG_CHEB2R=1: the
    residual at the recurrence's grade costs at most one CG iteration over
    the default, and the count is the JAX package's for the same
    construction (its fine level; here every smoothing level)."""
    _, base = MixedPrecisionPoisson(3, 4, 2, device="cpu").solve()
    monkeypatch.setenv("PMG_CHEB2R", "1")
    prob = MixedPrecisionPoisson(3, 4, 2, device="cpu")
    assert all(lvl.smoother.op_cheb2r is not None
               for lvl in prob.levels[1:])
    _, st = prob.solve()
    assert st.converged
    assert base.iterations <= st.iterations <= base.iterations + 1
    assert st.solution_l2_norm == pytest.approx(base.solution_l2_norm,
                                                rel=1e-7)
    out, err = jax_rout_solve.communicate(timeout=600)
    assert jax_rout_solve.returncode == 0, err
    jst = json.loads(out.strip().splitlines()[-1])
    assert jst["converged"] and st.iterations == jst["iterations"]
    assert st.solution_l2_norm == pytest.approx(jst["l2"], rel=1e-7)
