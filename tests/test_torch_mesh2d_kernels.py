"""The pencil kernel path's plain twins against the JAX package's pencil
kernels on the CPU: B.1's pencil instance (``CudaLaplacePencil``, ``apply``
on x-and-y-full input) against ``make_pallas_slab2d``'s ``_run("apply")``
(``_build_stacked_pallas2d``), ``ShardedCuda2DLaplace.apply`` against
JAX's ``ShardedPallas2DLaplace`` under shard_map and the single-device
apply, and B.2's pencil pair against the JAX package's xext+yext
``Cheb2Kernel`` (``_build_stacked_cheb2_2d``), both run in interpret mode
as ``tests/test_sharding.py`` runs them, on the same global inputs (numpy
seeds), on every pencil.  Each side takes the halo it takes: the port's
pair 2p and p planes and rows a side, the JAX kernel 2p and p planes and
its 8-rounded Hd and Hr rows.  Tolerances: the exact grade within 2e-5
max|want| (the JAX package's own bound for the pencil kernel apply),
duplicated points within 1e-6 max; the production grade within 8e-3
max|out| (two bf16 roundings at the largest value, as
``tests/test_torch_sharding_kernels.py`` holds the xext pair)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.ops.pallas_cheb2 import _roundup8
from portable_multigrid_tpu.parallel import mesh2d as jmesh2d
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_cheb2 import (
    MODES as PAIR_MODES,
    make_cheb2,
    make_cheb2_pencil,
)
from portable_multigrid_tpu_torch.ops.cuda_laplace import make_cuda_laplace
from portable_multigrid_tpu_torch.ops.laplace import make_laplace
from portable_multigrid_tpu_torch.parallel import mesh2d

torch.set_num_threads(1)

CPU = torch.device("cpu")
EXACT, BF16 = 2e-5, 8e-3
SCAL = np.asarray([0.59, 1.26, 0.71, 1.52, 1.3], np.float32)
# the pair modes of the pencil smoother
PENCIL_MODES = ("cheb2", "cheb2l", "cheb2f0", "cheb2f0l")


@pytest.fixture(scope="module", autouse=True)
def _pmg_defaults():
    """Every PMG_* setting of both packages at its default (the JAX
    kernels' lane padding reads PMG_ZPAD_UP)."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("PMG_")]:
            mp.delenv(key)
        yield


def _at(tree, i, j):
    return jax.tree_util.tree_map(lambda a: a[i, j], tree)


def _masked(rng, shape):
    """Random global trimmed state, zero on the constrained planes."""
    v = rng.standard_normal(shape).astype(np.float32)
    v[0], v[:, 0], v[:, :, 0] = 0.0, 0.0, 0.0
    return v


def _window(t, x0, nx, y0, ny):
    """Planes x0 .. x0 + nx - 1 and rows y0 .. y0 + ny - 1 of a global
    trimmed field, zeros off the grid."""
    N = t.shape[0]
    out = np.zeros((nx, ny) + t.shape[2:], t.dtype)
    a, b, c, d = max(x0, 0), min(x0 + nx, N), max(y0, 0), min(y0 + ny, N)
    out[a - x0: b - x0, c - y0: d - y0] = t[a:b, c:d]
    return out


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("p,r,mesh", [(4, 2, (2, 2)), (2, 3, (2, 2))])
def test_pencil_kernel_matches_jax(p, r, mesh):
    """B.1's pencil twin on every pencil's x-and-y-full input against
    JAX's pencil slab ``_run("apply")`` in interpret mode (which takes the
    full pencil, its y padded by the 7 rows of its aligned reads), float32,
    within 2e-5 max|want|."""
    sx, sy = mesh
    jsp = JSpace(JMesh(3, r), p)
    jop = jmesh2d._build_stacked_pallas2d(jsp, sx, sy, jnp.float32,
                                          interpret=True)
    assert jop is not None
    op = mesh2d._build_pencil_kernel(FESpace(HyperCubeMesh(3, r), p), mesh,
                                     [CPU] * (sx * sy), torch.float32)
    u = np.random.default_rng(p + r).standard_normal(
        jsp.grid_shape).astype(np.float32)
    n = jsp.mesh.cells_per_axis
    st = mesh2d.partition_2d(u, n, p, sx, sy)
    for s, loc in enumerate(op.local):
        full = st[s // sy, s % sy]
        want = _at(jop, s // sy, s % sy).local._run(
            "apply", jnp.pad(jnp.asarray(full), ((0, 0), (0, 7), (0, 0))))
        (got,) = loc.run("apply", torch.from_numpy(full[:, :, :-1].copy()))
        _close(got.numpy(), np.asarray(want), EXACT)


@pytest.mark.parametrize("p,r,mesh", [(4, 2, (2, 2)), (4, 3, (4, 2))])
def test_pencil_apply_matches_jax_and_single_device(p, r, mesh):
    """ShardedCuda2DLaplace.apply (B.1's pencil, the thin x plane and y
    row, halo_sum_2d, the mask combine) against JAX's
    ShardedPallas2DLaplace under shard_map and against the single-device
    float64 apply, float32, within 2e-5 max|want|; duplicated points
    within 1e-6."""
    sx, sy = mesh
    jsp = JSpace(JMesh(3, r), p)
    n = jsp.mesh.cells_per_axis
    u = np.random.default_rng(p * r).standard_normal(
        jsp.grid_shape).astype(np.float32)
    sop = jmesh2d._build_stacked_pallas2d(jsp, sx, sy, jnp.float32,
                                          interpret=True)
    mesh2 = Mesh(np.array(jax.devices()[: sx * sy]).reshape(sx, sy),
                 (jmesh2d.AX, jmesh2d.AY))
    spec = P(jmesh2d.AX, jmesh2d.AY)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda o, v: _at(o, 0, 0).apply(v[0, 0])[None, None], mesh=mesh2,
        in_specs=(spec, spec), out_specs=spec, check_vma=False))(
            sop, jnp.asarray(jmesh2d.partition_2d(u, n, p, sx, sy))))
    sp = FESpace(HyperCubeMesh(3, r), p)
    devices = [CPU] * (sx * sy)
    op = mesh2d._build_pencil_kernel(sp, mesh, devices, torch.float32)
    got = op.apply(mesh2d.shard_2d(u, n, p, mesh, devices, torch.float32))
    single = mesh2d.partition_2d(make_laplace(sp, torch.float64).apply(
        torch.from_numpy(u).double()).numpy(), n, p, sx, sy)
    scale = np.abs(want).max()
    for s, t in enumerate(got.parts):
        for ref in (want, single):
            np.testing.assert_allclose(t.numpy(), ref[s // sy, s % sy],
                                       rtol=0, atol=EXACT * scale)
    for s, t in enumerate(got.parts):
        if s % sy + 1 < sy:
            np.testing.assert_allclose(t[:, -1], got.parts[s + 1][:, 0],
                                       rtol=0, atol=1e-6 * scale)
        if s // sy + 1 < sx:
            np.testing.assert_allclose(t[-1], got.parts[s + sy][0], rtol=0,
                                       atol=1e-6 * scale)


@pytest.mark.parametrize("mode", PENCIL_MODES)
@pytest.mark.parametrize("p,r,exact", [(4, 2, True), (4, 2, False),
                                       (2, 3, False)])
def test_pencil_pair_matches_jax(p, r, exact, mode):
    """B.2's pencil twin against JAX's xext+yext Cheb2Kernel in interpret
    mode at float32 state on every pencil of (2, 2), from the same global
    d, r and x: the exact grade (JAX's ``exact=True``) and the production
    grade at Q4 r=2 (two-cell pencils), the production grade at Q2 r=3
    too."""
    sx, sy = 2, 2
    jk = jmesh2d._build_stacked_cheb2_2d(JSpace(JMesh(3, r), p), sx, sy,
                                         jnp.float32, interpret=True,
                                         exact=exact)
    assert jk is not None
    op = make_cuda_laplace(FESpace(HyperCubeMesh(3, r), p), torch.float32,
                           core="banded" if exact else "mxu")
    N = 2 ** r * p
    L = N // 2
    rng = np.random.default_rng(len(mode) + 10 * exact + p)
    d, rr, x = (_masked(rng, (N, N, N)) for _ in range(3))
    f0 = mode.startswith("cheb2f0")
    has_x = mode in ("cheb2", "cheb2l")
    scal = SCAL if f0 else SCAL[:4]
    Hd, Hr = _roundup8(2 * p), _roundup8(p)
    for s in range(sx * sy):
        lx, ly = s // sy * L, s % sy * L
        xs = x[lx: lx + L, ly: ly + L]
        jargs = (_window(d, lx - 2 * p, L + 4 * p, ly - Hd, L + 2 * Hd),
                 None if f0 else _window(rr, lx - p, L + 2 * p, ly - Hr,
                                         L + 2 * Hr),
                 xs if has_x else None)
        want = _at(jk, s // sy, s % sy).steps2(
            *(None if a is None else jnp.asarray(a) for a in jargs),
            jnp.asarray(scal), mode, sdtype="f32")
        args = (_window(d, lx - 2 * p, L + 4 * p, ly - 2 * p, L + 4 * p),
                None if f0 else _window(rr, lx - p, L + 2 * p, ly - p,
                                        L + 2 * p),
                xs.copy() if has_x else None)
        got = make_cheb2_pencil(op, lx, L, ly, L).steps2(
            *(None if a is None else torch.from_numpy(a) for a in args),
            tuple(map(float, scal)), mode)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g.numpy(), np.asarray(w), EXACT if exact else BF16)


@pytest.mark.parametrize("p,r,mesh", [(1, 3, (2, 4)), (3, 2, (2, 2)),
                                      (2, 3, (4, 2))])
def test_pencil_twin_is_the_single_device_twin(p, r, mesh):
    """On every pencil the pencil pair's twin gives the single-device
    pair's twin at the pencil's points, bit for bit, at both grades, in
    every mode."""
    sx, sy = mesh
    sp = FESpace(HyperCubeMesh(3, r), p)
    N = 2 ** r * p
    Lx, Ly = N // sx, N // sy
    rng = np.random.default_rng(p)
    d, rr, x = (torch.from_numpy(_masked(rng, (N, N, N))) for _ in range(3))
    for core in ("banded", "mxu"):
        op = make_cuda_laplace(sp, torch.float32, core=core)
        for mode in PAIR_MODES:
            f0 = mode.startswith("cheb2f0")
            has_x = mode in ("cheb2", "cheb2l")
            scal = tuple(map(float, SCAL if f0 else SCAL[:4]))
            want = make_cheb2(op).steps2(d, None if f0 else rr,
                                         x if has_x else None, scal, mode)
            for s in range(sx * sy):
                lx, ly = s // sy * Lx, s % sy * Ly

                def ext(t, h):
                    return torch.from_numpy(_window(
                        t.numpy(), lx - h, Lx + 2 * h, ly - h, Ly + 2 * h))

                got = make_cheb2_pencil(op, lx, Lx, ly, Ly).steps2(
                    ext(d, 2 * p), None if f0 else ext(rr, p),
                    ext(x, 0) if has_x else None, scal, mode)
                for g, w in zip(got, want):
                    assert torch.equal(g, w[lx: lx + Lx, ly: ly + Ly]), (
                        core, mode, s)


def test_pencil_kernels_check_their_inputs():
    """Shapes, modes and marches outside the grid are refused."""
    sp = FESpace(HyperCubeMesh(3, 2), 2)
    op = make_cuda_laplace(sp, torch.float32)
    k = make_cheb2_pencil(op, 4, 4, 0, 4)
    scal = tuple(map(float, SCAL[:4]))
    with pytest.raises(ValueError, match="shape"):
        k.steps2(torch.zeros(12, 8, 8), torch.zeros(8, 8, 8),
                 torch.zeros(4, 4, 8), scal)
    assert len(k.steps2(torch.zeros(12, 12, 8), torch.zeros(8, 8, 8),
                        torch.zeros(4, 4, 8), scal)) == 3
    with pytest.raises(ValueError, match="leaves the grid"):
        make_cheb2_pencil(op, 0, 4, 6, 4)
    pen = mesh2d._build_pencil_kernel(sp, (2, 2), [CPU] * 4,
                                      torch.float32).local[0]
    assert pen.input_shape == (5, 5, 8)
    with pytest.raises(ValueError, match="pencil mode"):
        pen.run("residual1f", torch.zeros(5, 5, 8), (torch.zeros(4, 4, 8),))
    with pytest.raises(ValueError, match="shape"):
        pen.run("apply", torch.zeros(4, 4, 8))


def test_pencil_eligibility():
    """The port's rule: 3D float32 levels whose cells split evenly on both
    sharded axes run the pencil; the pair needs two cells a pencil on
    each."""
    sp = FESpace(HyperCubeMesh(3, 2), 3)
    assert mesh2d.pencil_eligible(sp, (2, 4), torch.float32)
    assert not mesh2d.pencil_eligible(sp, (2, 2), torch.float64)
    assert not mesh2d.pencil_eligible(sp, (3, 2), torch.float32)
    assert not mesh2d.pencil_eligible(FESpace(HyperCubeMesh(2, 2), 3),
                                      (2, 2), torch.float32)
    assert mesh2d._build_pencil_cheb2(sp, (2, 2), [CPU] * 4,
                                      torch.float32) is not None
    assert mesh2d._build_pencil_cheb2(sp, (2, 4), [CPU] * 8,
                                      torch.float32) is None
