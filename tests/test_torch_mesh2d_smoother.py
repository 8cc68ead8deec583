"""The pencil kernel path as a whole on the CPU: ShardedFused2DChebyshev
(``apply`` and ``smooth``, an even and an odd step count) against the JAX
package's on the same levels and inputs (interpret mode, the conftest's
virtual devices), the kernel-path solve against the JAX package's counts
(``PMG_CHEB2=0`` too), and ``convert.pencil_levels`` on the JAX package's
level pytrees.  The port's kernel wrappers run their plain twins here.
Inputs come from numpy seeds."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.models.poisson import (
    GeometricMultigridPoisson as JPoisson,
)
from portable_multigrid_tpu.parallel import mesh2d as jmesh2d
from portable_multigrid_tpu.solvers.vcycle import MGLevel as JMGLevel
from portable_multigrid_tpu_torch.convert import pencil_levels
from portable_multigrid_tpu_torch.fem.assemble import assemble_rhs
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.parallel import mesh2d, sharding
from portable_multigrid_tpu_torch.solvers.cg import cg
from portable_multigrid_tpu_torch.solvers.chebyshev import Chebyshev
from portable_multigrid_tpu_torch.solvers.vcycle import VCycle

torch.set_num_threads(1)

CPU = torch.device("cpu")
THETA, DELTA = 1.3, 0.9
# the production pair against JAX's at its bf16 grade (the TPU core rounds
# per block, the port's the global bands), as tests/test_sharding.py holds
# the JAX pencil smoother against the single chip
TOL = 3e-3
# The JAX package's pencil kernel-path solve, float32, Q4 r=3 on (2, 2),
# rtol 1e-5, takes 2 CG iterations in interpret mode (~105 s here, too
# long for this file), as printed from the repo root by
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu')
#   jax.config.update('jax_num_cpu_devices', 4)
#   import jax.numpy as jnp
#   from portable_multigrid_tpu.parallel.mesh2d import Sharded2DGeometricPoisson as S
#   print(S(3, 4, 3, (2, 2), dtype=jnp.float32, variant='pallas',
#           pallas_interpret=True).solve(rtol=1e-5)[1].iterations)"
# tests/test_sharding.py holds it equal to the single-device float64 count,
# which the test below computes live.
JAX_PENCIL_PALLAS_ITERATIONS = 2


def _clear_pmg(mp):
    for key in [k for k in os.environ if k.startswith("PMG_")]:
        mp.delenv(key)


@pytest.fixture(autouse=True)
def _pmg_defaults(monkeypatch):
    """Every PMG_* setting of both packages at its default."""
    _clear_pmg(monkeypatch)


@pytest.fixture(scope="module")
def jax_single_q4r3():
    """The JAX package's single-device float64 Q4 r=3 solve, rtol 1e-5,
    at the default settings: (x, stats)."""
    with pytest.MonkeyPatch.context() as mp:
        _clear_pmg(mp)
        jx, jst = JPoisson(3, 4, 3, jnp.float64).solve(rtol=1e-5)
    return np.asarray(jx), jst


def _jax_level(p, r, mesh, degree):
    """A JAX pencil kernel level: ShardedPallas2DLaplace and the pair
    smoother ShardedFused2DChebyshev (interpret mode), stacked."""
    sx, sy = mesh
    jsp = JSpace(JMesh(3, r), p)
    op_st = jmesh2d._build_stacked_pallas2d(jsp, sx, sy, jnp.float32,
                                            interpret=True)
    sm_st = jmesh2d.ShardedFused2DChebyshev(
        sx=sx, sy=sy, degree=degree, op=op_st,
        op_cheb2=jmesh2d._build_stacked_cheb2_2d(jsp, sx, sy, jnp.float32,
                                                 interpret=True),
        theta=jnp.full((sx, sy), THETA, jnp.float32),
        delta=jnp.full((sx, sy), DELTA, jnp.float32))
    assert op_st is not None and sm_st.op_cheb2 is not None
    return JMGLevel(op=op_st, smoother=sm_st, transfer=None)


def _jax_smoother(level, p, r, mesh, u, b):
    """The JAX level's smoother under shard_map: (apply(b), smooth(u, b))
    as stacked pencils."""
    sx, sy = mesh
    n = 2 ** r
    sm_st = level.smoother

    def f(sm_stacked, u_st, b_st):
        sm = jax.tree_util.tree_map(lambda a: a[0, 0], sm_stacked)
        return (sm.apply(b_st[0, 0])[None, None],
                sm.smooth(u_st[0, 0], b_st[0, 0])[None, None])

    spec = P(jmesh2d.AX, jmesh2d.AY)
    devs = np.array(jax.devices()[: sx * sy]).reshape(sx, sy)
    outs = jax.jit(jax.shard_map(
        f, mesh=Mesh(devs, (jmesh2d.AX, jmesh2d.AY)), in_specs=(spec,) * 3,
        out_specs=(spec,) * 2, check_vma=False))(
            sm_st, jnp.asarray(jmesh2d.partition_2d(u, n, p, sx, sy)),
            jnp.asarray(jmesh2d.partition_2d(b, n, p, sx, sy)))
    return [np.asarray(o) for o in outs]


@pytest.mark.parametrize("degree", [5, 4])
def test_pencil_smoother_matches_jax(degree):
    """apply and smooth of the port's ShardedFused2DChebyshev, made from
    the JAX level by convert.pencil_levels, against the JAX package's,
    Q4 r=2 on (2, 2) (two-cell pencils): four recurrence steps (the entry
    pair, a pair) and three (the entry pair, a zero-coefficient tail
    pair); every pencil, the duplicated points consistent."""
    p, r, mesh = 4, 2, (2, 2)
    sx, sy = mesh
    rng = np.random.default_rng(degree)
    sp = FESpace(HyperCubeMesh(3, r), p)
    m = sp.free_mask()
    u, b = ((rng.standard_normal(sp.grid_shape) * m).astype(np.float32)
            for _ in range(2))
    level = _jax_level(p, r, mesh, degree)
    want = _jax_smoother(level, p, r, mesh, u, b)
    devices = [CPU] * (sx * sy)
    (lvl,) = pencil_levels([jax.tree_util.tree_map(np.asarray, level)],
                           devices, 0, mesh, torch.float32)
    sm = lvl.smoother
    assert isinstance(sm, mesh2d.ShardedFused2DChebyshev)
    assert (sm.degree, sm.theta, sm.delta) == (
        degree, float(np.float32(THETA)), float(np.float32(DELTA)))
    n = sp.mesh.cells_per_axis
    fu, fb = (mesh2d.shard_2d(v, n, p, mesh, devices, torch.float32)
              for v in (u, b))
    for got, w in zip((sm.apply(fb), sm.smooth(fu, fb)), want):
        scale = np.abs(w).max()
        for s, t in enumerate(got.parts):
            np.testing.assert_allclose(t.numpy(), w[s // sy, s % sy], rtol=0,
                                       atol=TOL * scale)
            if s % sy + 1 < sy:
                np.testing.assert_allclose(t[:, -1], got.parts[s + 1][:, 0],
                                           rtol=0, atol=1e-6 * scale)
            if s // sy + 1 < sx:
                np.testing.assert_allclose(t[-1], got.parts[s + sy][0],
                                           rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("pairs", ["1", "0"])
def test_kernel_path_solve_matches_jax(monkeypatch, jax_single_q4r3, pairs):
    """Sharded2DGeometricPoisson(3, 4, 3, (2, 2), float32, "auto") (the
    JAX package's "pallas"): the JAX package's pencil count, which equals
    its single-device float64 count, and x within 2e-5 max|x| of that
    solve's; with PMG_CHEB2=0 the levels smooth with plain Chebyshev on
    the pencil operator and take the same count."""
    monkeypatch.setenv("PMG_CHEB2", pairs)
    jx, jst = jax_single_q4r3
    prob = mesh2d.Sharded2DGeometricPoisson(3, 4, 3, (2, 2),
                                            devices=[CPU] * 4,
                                            dtype=torch.float32,
                                            variant="auto")
    fine = prob.levels[-1]
    assert isinstance(fine.op, mesh2d.ShardedCuda2DLaplace)
    assert isinstance(fine.smoother, mesh2d.ShardedFused2DChebyshev
                      if pairs == "1" else Chebyshev)
    # r = 1, one-cell pencils: the port's rule builds B.1's pencil (plain
    # Chebyshev on it); the JAX package's block picker refuses p = 4 there
    # ((b p) % 8 with b = 1) and runs kron; the counts agree all the same
    r1 = prob.levels[1]
    assert isinstance(r1.op, mesh2d.ShardedCuda2DLaplace)
    assert isinstance(r1.smoother, Chebyshev)
    x, st = prob.solve(rtol=1e-5)
    assert st.converged
    assert st.iterations == jst.iterations == JAX_PENCIL_PALLAS_ITERATIONS
    np.testing.assert_allclose(x, jx, rtol=0, atol=2e-5 * np.abs(jx).max())


def _np_levels(model):
    return jax.tree_util.tree_map(np.asarray, model.levels_stacked)


def test_convert_round_trips_plain_levels():
    """convert.pencil_levels on the JAX model's kron levels (NumPy, leading
    (sx, sy) axes): every array of every pencil equal to the JAX one, and
    CG over the converted V-cycle gives the JAX solve's count and x
    (float64, Q2 r=3 on (2, 2): a replicated level, the gather, two
    pencil levels)."""
    sx, sy = mesh = (2, 2)
    jm = jmesh2d.Sharded2DGeometricPoisson(3, 2, 3, mesh,
                                           devices=jax.devices()[:4])
    jx, jst = jm.solve()
    jl = _np_levels(jm)
    levels = pencil_levels(jl, [CPU] * 4, jm.n_replicated, mesh)
    assert isinstance(levels[1].transfer, mesh2d.Gather2DTransfer)
    for i, (jlvl, lvl) in enumerate(zip(jl, levels)):
        if i < jm.n_replicated:
            continue
        for s, loc in enumerate(lvl.op.local):
            for name in ("mask1", "dK1", "dM1", "Kg", "Mg"):
                for a, b in zip(getattr(loc, name), getattr(jlvl.op, name)):
                    np.testing.assert_array_equal(a.numpy(),
                                                  b[s // sy, s % sy])
        assert lvl.smoother.theta == float(jlvl.smoother.theta[0, 0])
    n, p = 8, 2
    w = mesh2d.dot_weights_2d(n, p, sx, sy)
    dot = sharding.make_sharded_dot(
        [torch.from_numpy(w[s // sy, s % sy]) for s in range(4)], 3)
    b = mesh2d.shard_2d(assemble_rhs(FESpace(HyperCubeMesh(3, 3), p)), n, p,
                        mesh, [CPU] * 4, torch.float64)
    res = cg(levels[-1].op.apply, b, VCycle(levels=levels).apply,
             rtol=1e-12, dot=dot)
    assert res.iterations == jst.iterations
    x = mesh2d.unpartition_2d(
        [[res.x.parts[i * sy + j].numpy() for j in range(sy)]
         for i in range(sx)], n, p, sx, sy)
    jx = np.asarray(jx)
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-10 * np.abs(jx).max())


def test_convert_kernel_levels():
    """The JAX model's pencil kernel path (interpret mode), Q4 r=3 on
    (2, 2): the converted levels carry B.1's pencils where JAX has its
    pencil kernel (with the same per-pencil factors and thin rows), the
    pair smoother where JAX has it, the JAX bounds; their V-cycle under
    CG gives the JAX package's pencil count."""
    sx, sy = mesh = (2, 2)
    jm = jmesh2d.Sharded2DGeometricPoisson(
        3, 4, 3, mesh, devices=jax.devices()[:4], dtype=jnp.float32,
        variant="pallas", pallas_interpret=True)
    levels = pencil_levels(_np_levels(jm), [CPU] * 4, jm.n_replicated, mesh,
                           torch.float32)
    for jlvl, lvl in zip(jm.levels_stacked[jm.n_replicated:],
                         levels[jm.n_replicated:]):
        kernel = type(jlvl.op).__name__ == "ShardedPallas2DLaplace"
        assert isinstance(lvl.op, mesh2d.ShardedCuda2DLaplace) == kernel
        assert isinstance(lvl.smoother, mesh2d.ShardedFused2DChebyshev) == (
            type(jlvl.smoother).__name__ == "ShardedFused2DChebyshev")
    assert isinstance(levels[-1].smoother, mesh2d.ShardedFused2DChebyshev)
    n, p = 8, 4
    w = mesh2d.dot_weights_2d(n, p, sx, sy)
    dot = sharding.make_sharded_dot(
        [torch.from_numpy(w[s // sy, s % sy]).float() for s in range(4)], 3)
    b = mesh2d.shard_2d(assemble_rhs(FESpace(HyperCubeMesh(3, 3), p)), n, p,
                        mesh, [CPU] * 4, torch.float32)
    res = cg(levels[-1].op.apply, b, VCycle(levels=levels).apply, rtol=1e-5,
             dot=dot)
    assert res.converged and res.iterations == JAX_PENCIL_PALLAS_ITERATIONS
