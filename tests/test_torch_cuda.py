"""On-card checks of the port's CUDA kernels (marked ``requires_cuda``).

Each kernel mode against its plain twin on the same CUDA tensors (B.1-B.3
in 3D, B.4 in 2D with partial tiles, B.5 at p = 1..7 with mu != lam and
B.3 on its [3, ...] fields), a 3D
and a 2D float64 solve through the kernels against the golden table, and a
float64 elasticity solve through the kernels against the JAX package's
values pinned in ``chip_smoke.py``, and the CUDA graph of the V-cycle
(``GraphedVCycle``) against the eager V-cycle on every model and on the
variable-coefficient solve, and the operator variants' products in full
float32 with a caller's TF32 switched on; and the bf16 smoother grade
(B.1's mxu core and bf16 state, B.2's production grade, B.4 at bf16
state, B.5's mxu core) and B.2's ``cheb2lr`` against the twins; the
fused coarse solve against the plain one, and its passes in a traced
graph's plan.  These
skip on a machine without a card; ``python3 chip_smoke.py`` runs the full
set of on-card checks.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from portable_multigrid_tpu_torch import (
    ElasticityMultigrid,
    GeometricMultigridPoisson,
    MixedMultigridPoisson,
    MixedPrecisionPoisson,
    PolynomialMultigridPoisson,
)
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops import (
    cuda_cheb2,
    cuda_elasticity,
    cuda_laplace,
    cuda_laplace2d,
    cuda_transfer,
)
from portable_multigrid_tpu_torch.ops.laplace import make_laplace
from portable_multigrid_tpu_torch.ops.structured import split_all
from portable_multigrid_tpu_torch.solvers.cg import cg
from portable_multigrid_tpu_torch.solvers.chebyshev import make_chebyshev
from portable_multigrid_tpu_torch.solvers.vcycle import GraphedVCycle, VCycle
from portable_multigrid_tpu_torch.utils import profiling

pytestmark = pytest.mark.requires_cuda

BOUND = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _field(n, rng, dtype, device, dim=3, lead=()):
    """A random trimmed field (``lead`` axes first), zero on the
    constrained first plane of every spatial axis."""
    m = np.ones(n)
    m[0] = 0.0
    v = rng.standard_normal(tuple(lead) + (n,) * dim)
    for ax in range(dim):
        v = v * m.reshape([n if a == ax else 1 for a in range(dim)])
    return torch.as_tensor(v, dtype=dtype, device=device)


_INS = {"apply": (), "residual1t": ("r",), "residual3t": ("r",),
        "chebd": ("r",), "chebdl": ("r",)}
_SCAL = {"apply": (), "residual1t": (), "residual3t": (1.3,)}


def _close(got, want, dtype):
    for g, w in zip(got, want):
        err = float((g - w).abs().max()) / float(w.abs().max())
        assert err <= BOUND[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", [1, 4, 7])
def test_kernels_match_twins(cuda, p, dtype):
    rng = np.random.default_rng(p)
    sp, sc = FESpace(HyperCubeMesh(3, 2), p), FESpace(HyperCubeMesh(3, 1), p)
    op = cuda_laplace.make_cuda_laplace(sp, dtype, cuda)
    u, r, x = (_field(2 * 2 * p, rng, dtype, cuda) for _ in range(3))
    for mode in cuda_laplace.MODES:
        ins = tuple({"r": r, "x": x}[k] for k in _INS.get(mode, ("r", "x")))
        scal = _SCAL.get(mode, (0.59, 1.26))
        _close(op.run(mode, u, ins, scal),
               cuda_laplace.laplace_twin(op, mode, u, ins, scal), dtype)
    kern = cuda_cheb2.make_cheb2(op)
    for mode in cuda_cheb2.MODES:
        f0 = mode.startswith("cheb2f0")
        args = (u, None if f0 else r, x if mode in ("cheb2", "cheb2l") else None,
                (0.59, 1.26, 0.71, 1.52) + ((1.3,) if f0 else ()))
        _close(kern.steps2(*args, mode), cuda_cheb2.cheb2_twin(op, *args, mode),
               dtype)
    tr = cuda_transfer.make_cuda_h_transfer(sc, sp, dtype, cuda)
    c = _field(2 * p, rng, dtype, cuda)
    twin = cuda_transfer.transfer_twin
    _close([tr.restrict(u)], [twin(tr.restrict_.dense, u)], dtype)
    _close([tr.prolongate_and_add(x, c)], [twin(tr.prolong.dense, c, x)], dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype,core", [(torch.float32, "banded"),
                                        (torch.float32, "mxu"),
                                        (torch.float64, "banded")])
@pytest.mark.parametrize("p", range(1, 8))
def test_untrimmed_residual_matches_twin(cuda, p, dtype, core):
    """B.1's untrimmed ``residual`` (u and rhs on the full grid, nonzero
    on its last planes; r0 and d0 trimmed, in the operator's dtype)
    against its twin at r = 2, at both cores (the mxu core in float32),
    one launch under its own key."""
    rng = np.random.default_rng(p)
    op = cuda_laplace.make_cuda_laplace(FESpace(HyperCubeMesh(3, 2), p),
                                        dtype, cuda, core=core)
    u, rhs = (torch.as_tensor(rng.standard_normal(op.grid_shape),
                              dtype=dtype, device=cuda) for _ in range(2))
    key = cuda_laplace.launch_key("residual", core, None)
    before = cuda_laplace.LAUNCHES.get(key, 0)
    got = op.run("residual", u, (rhs,), (1.3,))
    want = op.twin("residual", u, (rhs,), (1.3,))
    assert [g.dtype for g in got] == [dtype, dtype]
    assert all(tuple(g.shape) == op.trimmed_shape for g in got)
    (_close_bf16 if core == "mxu" else
     lambda g, w: _close(g, w, dtype))(got, want)
    torch.cuda.synchronize()
    assert cuda_laplace.LAUNCHES[key] == before + 1


# kernel against twin at the bf16 grade or bf16 state: a rounding to bf16
# may fall on the other side where the float32 sums differ in order
BF16_BOUND = 1e-2
BF16 = torch.bfloat16


def _close_bf16(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.isfinite(g.float()).all()
        err = float((g.float() - w.float()).abs().max())
        assert err <= BF16_BOUND * float(w.float().abs().max())


@pytest.mark.parametrize("p", [1, 2, 4, 7])
def test_bf16_grade_matches_twins(cuda, p):
    """B.1's mxu core at bf16 state (the cheb family), the exact B.1's
    residual3t with bf16 outputs, B.2's six modes at the production grade
    and bf16 state, each launched under its own counter."""
    rng = np.random.default_rng(p)
    sp = FESpace(HyperCubeMesh(3, 2), p)
    exact = cuda_laplace.make_cuda_laplace(sp, torch.float32, cuda)
    mxu = cuda_laplace.make_cuda_laplace(sp, torch.float32, cuda, core="mxu")
    u, r, x = (_field(4 * p, rng, torch.float32, cuda) for _ in range(3))
    d16, r16 = u.to(BF16), r.to(BF16)
    before = dict(cuda_laplace.LAUNCHES)
    _close_bf16(exact.run("residual3t", u, (r,), (1.3,), sdtype=BF16),
                exact.twin("residual3t", u, (r,), (1.3,), sdtype=BF16))
    for mode in ("cheb", "chebl", "chebd", "chebdl"):
        ins = (r16, x) if mode in ("cheb", "chebl") else (r16,)
        _close_bf16(mxu.run(mode, d16, ins, (0.59, 1.26), sdtype=BF16),
                    mxu.twin(mode, d16, ins, (0.59, 1.26), sdtype=BF16))
    kern = cuda_cheb2.make_cheb2(mxu)
    for mode in cuda_cheb2.MODES:
        f0 = mode.startswith("cheb2f0")
        args = ((r, None, None, (0.59, 1.26, 0.71, 1.52, 1.3)) if f0 else
                (d16, r16, x if mode in ("cheb2", "cheb2l") else None,
                 (0.59, 1.26, 0.71, 1.52)))
        _close_bf16(kern.steps2(*args, mode, sdtype=BF16),
                    cuda_cheb2.cheb2_twin(mxu, *args, mode, sdtype=BF16))
    torch.cuda.synchronize()
    after = cuda_laplace.LAUNCHES
    assert after.get("residual3t/bf16", 0) == before.get("residual3t/bf16",
                                                          0) + 1
    assert after.get("cheb/mxu/bf16", 0) == before.get("cheb/mxu/bf16", 0) + 1
    assert cuda_cheb2.LAUNCHES.get("cheb2f0/mxu/bf16", 0) >= 1


@pytest.mark.parametrize("p,r", [(1, 2), (3, 3), (7, 3)])
def test_laplace2d_bf16_state_matches_twin(cuda, p, r):
    """B.4 at bf16 state: residual3t writes r0, d0 in bf16, the cheb
    family reads d and r in bf16 (partial tiles)."""
    rng = np.random.default_rng(p)
    op = cuda_laplace2d.make_cuda_laplace2d(FESpace(HyperCubeMesh(2, r), p),
                                            torch.float32, cuda)
    u, r_, x = (_field(op.n * p, rng, torch.float32, cuda, dim=2)
                for _ in range(3))
    d16, r16 = u.to(BF16), r_.to(BF16)
    _close_bf16(op.run("residual3t", u, (r_,), (1.3,), sdtype=BF16),
                op.twin("residual3t", u, (r_,), (1.3,), sdtype=BF16))
    for mode in ("cheb", "chebl", "chebd", "chebdl"):
        ins = (r16, x) if mode in ("cheb", "chebl") else (r16,)
        _close_bf16(op.run(mode, d16, ins, (0.59, 1.26), sdtype=BF16),
                    op.twin(mode, d16, ins, (0.59, 1.26), sdtype=BF16))
    torch.cuda.synchronize()
    assert cuda_laplace2d.LAUNCHES.get("chebdl/bf16", 0) >= 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p,r", [(1, 2), (2, 3), (5, 2), (7, 3)])
def test_laplace2d_matches_twin(cuda, p, r, dtype):
    """Every B.4 mode against its twin; the grids are smaller than one tile
    or end in partial tiles."""
    rng = np.random.default_rng(p)
    op = cuda_laplace2d.make_cuda_laplace2d(FESpace(HyperCubeMesh(2, r), p),
                                            dtype, cuda)
    u, r_, x = (_field(op.n * p, rng, dtype, cuda, dim=2) for _ in range(3))
    before = sum(cuda_laplace2d.LAUNCHES.values())
    for mode in cuda_laplace.MODES:
        ins = tuple({"r": r_, "x": x}[k] for k in _INS.get(mode, ("r", "x")))
        scal = _SCAL.get(mode, (0.59, 1.26))
        _close(op.run(mode, u, ins, scal), op.twin(mode, u, ins, scal), dtype)
    torch.cuda.synchronize()
    assert sum(cuda_laplace2d.LAUNCHES.values()) == before + 7


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lx", [None, 11])
def test_laplace2d_chunks_and_partial_column(cuda, lx, dtype):
    """B.4 at 448^2 (p = 7, r = 6): four y columns of 128 points, the last
    one half full, in the x chunks of the launch's rule and in chunks of
    11 rows, the last one partial."""
    p = 7
    rng = np.random.default_rng(p)
    op = cuda_laplace2d.make_cuda_laplace2d(FESpace(HyperCubeMesh(2, 6), p),
                                            dtype, cuda)
    if lx:
        op = dataclasses.replace(op, tile=(lx,) + op.tile[1:])
    N = op.n * p
    assert N % op.tile[1] and -(-N // op.tile[0]) > 1
    u, r_, x = (_field(N, rng, dtype, cuda, dim=2) for _ in range(3))
    for mode in cuda_laplace.MODES:
        ins = tuple({"r": r_, "x": x}[k] for k in _INS.get(mode, ("r", "x")))
        scal = _SCAL.get(mode, (0.59, 1.26))
        _close(op.run(mode, u, ins, scal), op.twin(mode, u, ins, scal), dtype)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", range(1, 8))
def test_elasticity_matches_twin(cuda, p, dtype):
    """Every B.5 mode against its twin at r = 2 (partial tiles), with
    mu != lam so that a swap of G and G^T or of mu and lam would show; and
    B.3 on the path's [3, ...] fields, one launch per pass."""
    rng = np.random.default_rng(p)
    sp, sc = FESpace(HyperCubeMesh(3, 2), p), FESpace(HyperCubeMesh(3, 1), p)
    op = cuda_elasticity.make_cuda_elasticity(sp, dtype, *chip_smoke.MU_LAM,
                                              cuda)
    u, r, x = (_field(op.n * p, rng, dtype, cuda, lead=(3,)) for _ in range(3))
    before = sum(cuda_elasticity.LAUNCHES.values())
    for mode in cuda_laplace.MODES:
        ins = tuple({"r": r, "x": x}[k] for k in _INS.get(mode, ("r", "x")))
        scal = _SCAL.get(mode, (0.59, 1.26))
        _close(op.run(mode, u, ins, scal), op.twin(mode, u, ins, scal), dtype)
    tr = cuda_transfer.make_cuda_h_transfer(sc, sp, dtype, cuda)
    c = _field(2 * p, rng, dtype, cuda, lead=(3,))
    twin = cuda_transfer.transfer_twin
    moved = sum(cuda_transfer.LAUNCHES.values())
    _close([tr.restrict(u)], [twin(tr.restrict_.dense, u)], dtype)
    _close([tr.prolongate(c)], [twin(tr.prolong.dense, c)], dtype)
    _close([tr.prolongate_and_add(x, c)], [twin(tr.prolong.dense, c, x)], dtype)
    torch.cuda.synchronize()
    assert sum(cuda_elasticity.LAUNCHES.values()) == before + 7
    assert sum(cuda_transfer.LAUNCHES.values()) == moved + 3


@pytest.mark.parametrize("p", range(1, 8))
def test_elasticity_mxu_matches_twin(cuda, p):
    """Every B.5 mode at the mxu grade (float32 state) against its twin at
    r = 2, each launched under its own counter (``cheb/mxu``)."""
    rng = np.random.default_rng(p)
    op = cuda_elasticity.make_cuda_elasticity(
        FESpace(HyperCubeMesh(3, 2), p), torch.float32, *chip_smoke.MU_LAM,
        cuda, core="mxu")
    u, r, x = (_field(op.n * p, rng, torch.float32, cuda, lead=(3,))
               for _ in range(3))
    before = cuda_elasticity.LAUNCHES.get("cheb/mxu", 0)
    for mode in cuda_laplace.MODES:
        ins = tuple({"r": r, "x": x}[k] for k in _INS.get(mode, ("r", "x")))
        scal = _SCAL.get(mode, (0.59, 1.26))
        _close_bf16(op.run(mode, u, ins, scal), op.twin(mode, u, ins, scal))
    torch.cuda.synchronize()
    assert cuda_elasticity.LAUNCHES["cheb/mxu"] == before + 1


@pytest.mark.parametrize("p", range(1, 8))
def test_cheb2lr_matches_twin(cuda, p):
    """B.2's cheb2lr at the exact grade (float32 and float64) and at the
    production grade with bf16 state, against its twin at r = 2, where its
    tile fits; where it does not, make_cheb2(op, rout=True) refuses."""
    rng = np.random.default_rng(p)
    sp = FESpace(HyperCubeMesh(3, 2), p)
    scal = (0.59, 1.26, 0.71, 1.52)
    for dtype, core, sd in ((torch.float32, "banded", None),
                            (torch.float64, "banded", None),
                            (torch.float32, "mxu", BF16)):
        op = cuda_laplace.make_cuda_laplace(sp, dtype, cuda, core=core)
        if not cuda_cheb2.cheb2_fits(op, rout=True):
            assert p > (5 if dtype == torch.float32 else 3)
            with pytest.raises(ValueError):
                cuda_cheb2.make_cheb2(op, rout=True)
            continue
        kern = cuda_cheb2.make_cheb2(op, rout=True)
        d, r, x = (_field(4 * p, rng, dtype, cuda) for _ in range(3))
        if sd is not None:
            d, r = d.to(sd), r.to(sd)
        got = kern.steps2(d, r, x, scal, "cheb2lr", sdtype=sd)
        want = cuda_cheb2.cheb2_twin(op, d, r, x, scal, "cheb2lr", sd)
        if sd is None:
            _close(got, want, dtype)
        else:
            _close_bf16(got, want)
    torch.cuda.synchronize()


def _halo_window(f, lo, n, h, axis):
    """Planes (rows) lo - h .. lo + n + h of f along ``axis``, zeros off
    the grid: a shard's (a pencil's) input with its halo."""
    shape = list(f.shape)
    shape[axis] = n + 2 * h
    out = torch.zeros(shape, dtype=f.dtype, device=f.device)
    a, b = max(lo - h, 0), min(lo + n + h, f.shape[axis])
    out.narrow(axis, a - lo + h, b - a).copy_(f.narrow(axis, a, b - a))
    return out


def _pair_args(mode, d, r, x, b):
    scal = (0.59, 1.26, 0.71, 1.52)
    if mode.startswith("cheb2f0"):
        return b, None, None, scal + (1.3,)
    return d, r, x if mode in ("cheb2", "cheb2l") else None, scal


@pytest.mark.parametrize("p", range(1, 8))
def test_cheb2_mma_matches_twin(cuda, p):
    """B.2's tensor-core instance (the production grade in float32) in all
    six modes at float and bf16 state against the twin at r = 3 (N = 8p:
    partial y-z columns), each launch counted in LAUNCHES under its mxu
    key; on a shard of four (xext) and a pencil of (2, 2) (yext) at
    bf16 state against their twins and bit for bit the cube's pair."""
    rng = np.random.default_rng(p)
    op = cuda_laplace.make_cuda_laplace(FESpace(HyperCubeMesh(3, 3), p),
                                        torch.float32, cuda, core="mxu")
    N = op.n * p
    kern = cuda_cheb2.make_cheb2(op)
    assert kern.op.core == "mxu"
    d, r, x, b = (_field(N, rng, torch.float32, cuda) for _ in range(4))
    all_ = dict(cuda_cheb2.LAUNCHES)
    for sd in (None, BF16):
        ds, rs = (d, r) if sd is None else (d.to(sd), r.to(sd))
        for mode in cuda_cheb2.MODES:
            args = _pair_args(mode, ds, rs, x, b)
            _close_bf16(kern.steps2(*args, mode, sdtype=sd),
                        cuda_cheb2.cheb2_twin(op, *args, mode, sd))
    torch.cuda.synchronize()
    moved = {k: v - all_.get(k, 0) for k, v in cuda_cheb2.LAUNCHES.items()
             if v != all_.get(k, 0)}
    assert sum(moved.values()) == 12
    assert all("/mxu" in k for k in moved)
    d16, r16 = d.to(BF16), r.to(BF16)
    L = N // 4
    shard = cuda_cheb2.make_cheb2_xext(op, L, L)
    pencil = cuda_cheb2.make_cheb2_pencil(op, N // 2, N // 2, 0, N // 2)
    assert shard.op.core == pencil.op.core == "mxu"
    for mode in cuda_cheb2.MODES:
        whole = kern.steps2(*_pair_args(mode, d16, r16, x, b), mode,
                            sdtype=BF16)
        f0 = mode.startswith("cheb2f0")
        hr = (2 if f0 else 1) * p
        xs = slice(L, 2 * L)
        args = _pair_args(mode, _halo_window(d16, L, L, 2 * p, 0),
                          _halo_window(r16, L, L, hr, 0), x[xs].contiguous(),
                          _halo_window(b, L, L, 2 * p, 0))
        got = shard.steps2(*args, mode, sdtype=BF16)
        _close_bf16(got, cuda_cheb2.cheb2_twin_xext(op, L, L, *args, mode,
                                                    BF16))
        assert all(torch.equal(g, w[xs]) for g, w in zip(got, whole))
        px, py = slice(N // 2, N), slice(0, N // 2)

        def cut(f, h):
            return _halo_window(_halo_window(f, N // 2, N // 2, h, 0), 0,
                                N // 2, h, 1)

        args = _pair_args(mode, cut(d16, 2 * p), cut(r16, hr),
                          x[px, py].contiguous(), cut(b, 2 * p))
        got = pencil.steps2(*args, mode, sdtype=BF16)
        _close_bf16(got, cuda_cheb2.cheb2_twin_pencil(
            op, N // 2, N // 2, 0, N // 2, *args, mode, BF16))
        assert all(torch.equal(g, w[px, py]) for g, w in zip(got, whole))
    torch.cuda.synchronize()


@pytest.mark.parametrize("p,r", [(3, 2), (3, 5), (5, 2), (5, 5)])
def test_elasticity_mma_matches_twin(cuda, p, r):
    """B.5's tensor-core instance (the mxu core in float32) in all seven
    modes against the twin, N = p 2^r a multiple of the tile's TY and 32
    z lanes (r = 5) and not (r = 2), each launch counted in LAUNCHES under
    its mxu key; the exact core and float64 keep the CUDA-core kernel,
    whose entry refuses the mxu grade (kRoundBF16)."""
    rng = np.random.default_rng(p + r)
    sp = FESpace(HyperCubeMesh(3, r), p)
    op = cuda_elasticity.make_cuda_elasticity(sp, torch.float32,
                                              *chip_smoke.MU_LAM, cuda,
                                              core="mxu")
    N = op.n * p
    assert op.core == "mxu" and (N % 32 == 0) == (r == 5)
    assert (N % op.tile[1] == 0) == (r == 5)
    u, r_, x = (_field(N, rng, torch.float32, cuda, lead=(3,))
                for _ in range(3))

    def counts():
        """(launches at the mxu core, all launches) so far."""
        c = cuda_elasticity.LAUNCHES
        return (sum(v for k, v in c.items() if k.endswith("/mxu")),
                sum(c.values()))

    mxu, all_ = counts()
    for mode in cuda_laplace.MODES:
        ins = tuple({"r": r_, "x": x}[k] for k in _INS.get(mode, ("r", "x")))
        scal = _SCAL.get(mode, (0.59, 1.26))
        _close_bf16(op.run(mode, u, ins, scal), op.twin(mode, u, ins, scal))
    torch.cuda.synchronize()
    assert counts() == (mxu + 7, all_ + 7)
    for dtype in (torch.float32, torch.float64):
        exact = cuda_elasticity.make_cuda_elasticity(sp, dtype,
                                                     *chip_smoke.MU_LAM, cuda)
        assert exact.core == "banded"
        ud = u.to(dtype)
        _close(exact.run("apply", ud), exact.twin("apply", ud), dtype)
    torch.cuda.synchronize()
    assert counts() == (mxu + 7, all_ + 9)

    class CudaCoreAtMxu(cuda_elasticity.CudaElasticityOperator):
        def kernel_fn(self):
            return cuda_laplace.CudaLaplaceOperator.kernel_fn(self)

    fields = {f.name: getattr(op, f.name) for f in dataclasses.fields(op)}
    fields["tile"] = cuda_elasticity.elasticity_tile(p, 4, N)
    with pytest.raises(RuntimeError, match=r"CUDA error 1\b"):
        CudaCoreAtMxu(**fields).run("apply", u)


def test_mma_launches_by_grade(cuda):
    """One eager V-cycle of the main path runs all its pairs at the
    production grade (LAUNCHES' /mxu/bf16 keys: the tensor cores); the
    exact grade's and float64's pairs count under their exact keys."""
    prob = GeometricMultigridPoisson(3, 4, 3, torch.float32, "auto", cuda)
    b = prob.rhs()
    all_ = dict(cuda_cheb2.LAUNCHES)
    prob.preconditioner(graph=False).apply(b)
    torch.cuda.synchronize()
    moved = {k: v - all_.get(k, 0) for k, v in cuda_cheb2.LAUNCHES.items()
             if v != all_.get(k, 0)}
    assert moved
    assert all(k.endswith("/mxu/bf16") for k in moved)
    rng = np.random.default_rng(0)
    sp = FESpace(HyperCubeMesh(3, 2), 4)
    for dtype in (torch.float32, torch.float64):
        op = cuda_laplace.make_cuda_laplace(sp, dtype, cuda)
        kern = cuda_cheb2.make_cheb2(op)
        assert kern.op.core == "banded"
        d, r, x = (_field(op.n * 4, rng, dtype, cuda) for _ in range(3))
        all_ = dict(cuda_cheb2.LAUNCHES)
        _close(kern.steps2(d, r, x, (0.59, 1.26, 0.71, 1.52), "cheb2"),
               cuda_cheb2.cheb2_twin(op, d, r, x, (0.59, 1.26, 0.71, 1.52),
                                     "cheb2"), dtype)
        torch.cuda.synchronize()
        moved = {k: v - all_.get(k, 0)
                 for k, v in cuda_cheb2.LAUNCHES.items()
                 if v != all_.get(k, 0)}
        assert moved == {"cheb2": 1}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dim,p,r", [(2, 1, 9), (2, 1, 2)]
                         + [(3, p, 0) for p in range(1, 8)] + [(3, 1, 2)])
def test_fused_coarse_solve_matches_plain(cuda, dim, p, r, dtype):
    """The coarsest level's Chebyshev-as-solver as the models build it,
    fused (one kernel pass a recurrence step), against the plain
    ``Chebyshev`` on the kernel's full-grid apply: equal on the free DoFs
    to the dtype's rounding, zero on the constrained ones.  2D p = 1 at
    r = 9 is the 512^2 coarse level of the 2D benchmark cell."""
    sp = FESpace(HyperCubeMesh(dim, r), p)
    make_op = {2: cuda_laplace2d.make_cuda_laplace2d,
               3: cuda_laplace.make_cuda_laplace}[dim]
    op = make_op(sp, dtype, cuda)
    kw = dict(smoothing_range=1e-3, degree=None, eig_cg_n_iterations=sp.n_dofs)
    plain = make_chebyshev(op, **kw)
    fused = make_chebyshev(op, fused=True, **kw)
    assert (fused.degree, fused.theta, fused.delta) == (
        plain.degree, plain.theta, plain.delta)
    rng = np.random.default_rng(dim * 10 + p)
    b = torch.as_tensor(rng.standard_normal(op.shape), dtype=dtype,
                        device=cuda) * op.mask
    trim = (slice(0, -1),) * dim
    want = plain.apply(b)[trim]
    before = dict(op.launches)
    got = fused.apply(b[trim].contiguous())
    torch.cuda.synchronize()
    moved = {k: v - before.get(k, 0) for k, v in op.launches.items()
             if v != before.get(k, 0)}
    assert sum(moved.values()) == fused.degree - 1 and "apply" not in moved
    free = op.mask[trim] != 0
    assert not got[~free].any()
    if free.any():
        _close([got], [want], dtype)


def test_traced_graph_counts_the_coarse_passes(cuda):
    """A V-cycle graph captured under tracing keeps the coarse level's
    passes in its plan: degree - 1 of the cheb family, no apply."""
    prob = PolynomialMultigridPoisson(2, 3, 4, dtype=torch.float32,
                                      device=cuda)
    mg = prob.preconditioner()
    with profiling.tracing():
        mg.apply(prob.rhs())
    op, sm = prob.levels[0].op, prob.levels[0].smoother
    tail = f".p{op.degree}.n{op.n}"
    coarse = {k: v for k, v in mg.span_plan.counts.items()
              if k.startswith("pmg.laplace2d.") and k.endswith(tail)}
    assert sum(coarse.values()) == sm.degree - 1
    assert f"pmg.laplace2d.apply{tail}" not in coarse


def test_graphed_q4_solve_keeps_its_cg_count(cuda):
    """The main path (Q4 r=6, float32, the pairs on the tensor cores):
    float32 CG to rtol 1e-5 through the graphed V-cycle takes 2
    iterations, as it did with the CUDA-core pairs."""
    prob = GeometricMultigridPoisson(3, 4, 6, torch.float32, "auto", cuda)
    res = cg(prob.fine_operator.apply, prob.rhs(), prob.preconditioner().apply,
             rtol=1e-5)
    assert res.converged and res.iterations == 2


@pytest.mark.parametrize("mode", cuda_transfer.MODES)
def test_vector_transfer_is_one_launch(cuda, mode):
    """A B.3 pass over a [3, ...] field launches the kernel once (the
    component is a grid axis) and matches the twin, at a shape with
    several restriction chunks (24 coarse rows)."""
    p, dtype = 3, torch.float32
    rng = np.random.default_rng(3)
    tr = cuda_transfer.make_cuda_h_transfer(FESpace(HyperCubeMesh(3, 3), p),
                                            FESpace(HyperCubeMesh(3, 4), p),
                                            dtype, cuda)
    f, dst = (_field(16 * p, rng, dtype, cuda, lead=(3,)) for _ in range(2))
    c = _field(8 * p, rng, dtype, cuda, lead=(3,))
    twin = cuda_transfer.transfer_twin
    run, want = {
        "restrict": (lambda: tr.restrict(f), twin(tr.restrict_.dense, f)),
        "prolongate": (lambda: tr.prolongate(c), twin(tr.prolong.dense, c)),
        "prolongate_and_add": (lambda: tr.prolongate_and_add(dst, c),
                               twin(tr.prolong.dense, c, dst)),
    }[mode]
    before = cuda_transfer.LAUNCHES[mode]
    got = run()
    torch.cuda.synchronize()
    assert cuda_transfer.LAUNCHES[mode] == before + 1
    _close([got], [want], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p,lead", [(7, ()), (6, ()), (4, (3,))],
                         ids=["widest", "scalar", "vector"])
def test_prolongation_in_chunks(cuda, p, lead, dtype):
    """B.3's prolongation, plain and with the addend, one refinement up to
    r = 4 (p = 7: 56^3 to 112^3, rows of w = 8 taps over a partial z tile;
    p = 6: 96^3 and p = 4: 3 x 64^3, where the launch's last x chunk is
    partial in both dtypes), in several x chunks; one launch a pass."""
    rng = np.random.default_rng(p)
    tr = cuda_transfer.make_cuda_h_transfer(FESpace(HyperCubeMesh(3, 3), p),
                                            FESpace(HyperCubeMesh(3, 4), p),
                                            dtype, cuda)
    W = tr.prolong
    count = int(np.prod(lead))
    lx = cuda_transfer.prolong_chunk(W.n_out, W.w, count,
                                     torch.empty((), dtype=dtype).element_size())
    assert W.w == p + 1 and -(-W.n_out // lx) > 1 and (p == 7 or W.n_out % lx)
    c = _field(W.n_in, rng, dtype, cuda, lead=lead)
    dst = _field(W.n_out, rng, dtype, cuda, lead=lead)
    before = dict(cuda_transfer.LAUNCHES)
    _close([tr.prolongate(c)], [cuda_transfer.transfer_twin(W.dense, c)], dtype)
    _close([tr.prolongate_and_add(dst, c)],
           [cuda_transfer.transfer_twin(W.dense, c, dst)], dtype)
    torch.cuda.synchronize()
    assert cuda_transfer.LAUNCHES["prolongate"] == before["prolongate"] + 1
    assert (cuda_transfer.LAUNCHES["prolongate_and_add"]
            == before["prolongate_and_add"] + 1)


def test_elasticity_row_through_kernels(cuda):
    iterations, l2 = chip_smoke.ELASTICITY_F64[(2, 2)]
    x, st = ElasticityMultigrid(3, 2, 2, dtype=torch.float64, variant="auto",
                                device=cuda).solve()
    assert x.is_cuda and st.iterations == iterations
    assert st.solution_l2_norm == pytest.approx(l2, rel=1e-10)


def test_polynomial_golden_row_through_kernels(cuda):
    path = os.path.join(os.path.dirname(__file__), "golden_convergence.json")
    with open(path) as fh:
        want = [r for r in json.load(fh)["polynomial_2d"]
                if r["refinements"] == 2][0]
    x, st = PolynomialMultigridPoisson(2, want["degree"], 2, want["levels"],
                                       torch.float64, "auto", cuda).solve()
    assert x.is_cuda and st.iterations == want["iterations"]
    assert st.solution_l2_norm == pytest.approx(want["l2_norm"], rel=1e-10)


def test_golden_row_through_kernels(cuda):
    path = os.path.join(os.path.dirname(__file__), "golden_convergence.json")
    with open(path) as fh:
        want = [r for r in json.load(fh)["geometric_3d"]
                if (r["degree"], r["refinements"]) == (2, 2)][0]
    x, st = GeometricMultigridPoisson(3, 2, 2, torch.float64, "auto",
                                      cuda).solve()
    assert x.is_cuda and st.iterations == want["iterations"]
    assert st.solution_l2_norm == pytest.approx(want["l2_norm"], rel=1e-10)


# one small model of each path: (model, args, kwargs)
GRAPH_MODELS = {
    "3d": (GeometricMultigridPoisson, (3, 4, 2), {}),
    "2d": (PolynomialMultigridPoisson, (2, 7, 2, 7), {}),
    "elasticity": (ElasticityMultigrid, (3, 2, 2), dict(mu=0.7, lam=1.3)),
    "mixed": (MixedMultigridPoisson, (3, 2, (1, 2, 4)), {}),
    "mixed_precision": (MixedPrecisionPoisson, (3, 4, 2), {}),
}


def _model(name, dtype, device):
    model, args, kw = GRAPH_MODELS[name]
    if model is MixedPrecisionPoisson:
        return model(*args, mg_dtype=dtype, variant="auto", device=device)
    return model(*args, dtype=dtype, variant="auto", device=device, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(GRAPH_MODELS))
def test_graphed_vcycle_equals_eager(cuda, name, dtype):
    """Replays of the graph give the eager V-cycle bit for bit, and a
    second replay with a new input gives that input's V-cycle."""
    prob = _model(name, dtype, cuda)
    graphed = prob.preconditioner()
    eager = prob.preconditioner(graph=False)
    assert isinstance(graphed, GraphedVCycle) and type(eager) is VCycle
    rng = np.random.default_rng(0)
    b = prob.rhs()
    b2 = b * torch.as_tensor(rng.uniform(0.5, 1.5, tuple(b.shape)),
                             dtype=b.dtype, device=cuda)
    g1 = graphed.apply(b)
    g2 = graphed.apply(b2)
    e1, e2 = eager.apply(b), eager.apply(b2)
    torch.cuda.synchronize()
    assert torch.equal(g1, e1) and torch.equal(g2, e2)
    assert not torch.equal(g1, g2)
    assert len(graphed._graphs) == 1


@pytest.mark.parametrize("name", ["3d", "mixed_precision"])
def test_cg_through_graph_equals_eager(cuda, name):
    """CG with the graphed V-cycle: the eager solve's count and x."""
    prob = _model(name, torch.float32, cuda)
    runs = [prob.solve(rtol=1e-10, graph=graph) for graph in (True, False)]
    (xg, sg), (xe, se) = runs
    assert sg.iterations == se.iterations and sg.converged
    assert torch.equal(xg, xe)


def test_capture_error_raises(cuda):
    """A V-cycle that reads the device from the host cannot be captured:
    the capture raises and nothing runs eagerly in its place."""
    prob = _model("3d", torch.float32, cuda)

    class HostRead(VCycle):
        def apply(self, src):
            out = super().apply(src)
            float(out.sum())  # a host read, refused under capture
            return out

    graphed = GraphedVCycle(HostRead(levels=prob.levels,
                                     fine_trimmed=prob.fine_trimmed))
    with pytest.raises(RuntimeError):
        graphed.apply(prob.rhs())
    assert not graphed._graphs


def test_graphed_vcycle_refuses_cpu(cuda):
    prob = _model("3d", torch.float32, cuda)
    with pytest.raises(ValueError, match="CUDA device"):
        prob.preconditioner().apply(prob.rhs().cpu())


@pytest.mark.parametrize("variant", ["qdense", "sumfac"])
def test_varcoef_graphed_equals_eager(cuda, monkeypatch, variant):
    """The variable-coefficient V-cycle (plain operators, no kernel): the
    graph's replay equals the eager V-cycle bit for bit, and the solve
    through it gives the eager solve's count and x."""
    monkeypatch.setenv("PMG_VARCOEFF_VARIANT", variant)
    prob = GeometricMultigridPoisson(3, 4, 2, torch.float32, device=cuda,
                                     coefficient=chip_smoke.coefficient)
    assert {lvl.op.variant for lvl in prob.levels} == {variant}
    b = prob.rhs()
    graphed = prob.preconditioner()
    assert isinstance(graphed, GraphedVCycle)
    assert torch.equal(graphed.apply(b), prob.preconditioner(
        graph=False).apply(b))
    (xg, sg), (xe, se) = (prob.solve(rtol=1e-5, graph=graph)
                          for graph in (True, False))
    assert sg.converged and sg.iterations == se.iterations
    assert torch.equal(xg, xe)


def _rel32(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("variant", ["qdense", "qbanded", "sumfac", "dense"])
def test_matmuls_stay_full_float32(cuda, variant):
    """TF32 keeps about three digits, far below what CG and the golden
    counts need: with a caller's TF32 switched on, the variants' products
    still run in full float32 (``structured.exact_matmuls`` switches it
    off) and the float32 apply on the card keeps float32's digits against
    the float64 apply on the CPU."""
    sp = FESpace(HyperCubeMesh(3, 2), 4)
    coef = None if variant == "dense" else chip_smoke.coefficient
    u = torch.as_tensor(np.random.default_rng(3).standard_normal(
        sp.grid_shape))
    want = make_laplace(sp, torch.float64, variant,
                        coefficient=coef).apply(u)
    op = make_laplace(sp, torch.float32, variant, cuda, coefficient=coef)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        if variant == "qdense":
            # the first product with TF32 on: about three digits
            flat = op._to_elements(split_all(u.float().to(cuda), 3, op.n, 4))
            want_g = op._to_elements(split_all(u, 3, op.n, 4)) @ \
                make_laplace(sp, torch.float64, variant,
                             coefficient=coef).Gmat
            assert _rel32(flat @ op.Gmat, want_g) > 1e-5
        got = op.apply(u.float().to(cuda))
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert _rel32(got, want) < 1e-5
