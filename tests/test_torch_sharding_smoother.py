"""The sharded kernel path as a whole on the CPU: ShardedFusedChebyshev
(``smooth``, ``apply``, ``residual``) against the JAX package's on the
same stacked state and inputs (interpret mode, the conftest's virtual
devices), the kernel-path solves against the JAX package's counts, and
``convert.sharded_levels`` on the JAX package's level pytrees.  The port's
kernel wrappers run their plain twins here.  Inputs come from numpy
seeds."""

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
from portable_multigrid_tpu.parallel import poisson as jpoisson
from portable_multigrid_tpu.parallel import sharding as jsharding
from portable_multigrid_tpu_torch import GeometricMultigridPoisson
from portable_multigrid_tpu_torch.convert import sharded_levels
from portable_multigrid_tpu_torch.fem.assemble import assemble_rhs
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.parallel import sharding
from portable_multigrid_tpu_torch.parallel.poisson import (
    ShardedGeometricPoisson,
    _build_stacked_cheb2,
    _build_stacked_slab,
)
from portable_multigrid_tpu_torch.solvers.cg import cg
from portable_multigrid_tpu_torch.solvers.vcycle import VCycle

torch.set_num_threads(1)

CPU = torch.device("cpu")
THETA, DELTA = 1.3, 0.9
# the exact cores against JAX: float32 roundoff; the mxu core and the
# production pair against JAX at their bf16 grade (the TPU core rounds per
# block, the port's the global bands)
TOL = {"banded": 2e-5, "mxu": 3e-3}
# The JAX package's sharded kernel-path solve, float32, Q4 r=3 S=4, rtol
# 1e-5, takes 2 CG iterations in interpret mode (~80 s here, too long for
# this file), as printed from the repo root by
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu')
#   jax.config.update('jax_num_cpu_devices', 4)
#   import jax.numpy as jnp
#   from portable_multigrid_tpu.parallel.poisson import ShardedGeometricPoisson as S
#   print(S(3, 4, 3, dtype=jnp.float32, variant='pallas',
#           pallas_interpret=True).solve(rtol=1e-5)[1].iterations)"
# tests/test_sharding.py holds it equal to the single-device float64 count,
# which the test below computes live.
JAX_SHARDED_PALLAS_ITERATIONS = 2


@pytest.fixture(scope="module", autouse=True)
def _pmg_defaults():
    """Every PMG_* setting of both packages at its default."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("PMG_")]:
            mp.delenv(key)
        yield


def _jax_smoother(p, r, S, degree, core, pairs, u, b):
    """JAX's ShardedFusedChebyshev under shard_map: (apply(b), smooth(u,
    b), residual(u, b)) as stacked slabs."""
    jsp = JSpace(JMesh(3, r), p)
    n = jsp.mesh.cells_per_axis
    op_st = jpoisson._build_stacked_pallas(jsp, S, jnp.float32,
                                           interpret=True)
    sm_op = jpoisson._build_stacked_pallas(jsp, S, jnp.float32, core=core,
                                           interpret=True)
    k2 = (jpoisson._build_stacked_cheb2(jsp, S, jnp.float32, interpret=True,
                                        bx=2, by=4) if pairs else None)
    sm_st = jsharding.ShardedFusedChebyshev(
        axis_name=jpoisson.AXIS, n_shards=S, degree=degree, op=op_st,
        op_smooth=sm_op, op_cheb2=k2,
        theta=jnp.full((S,), THETA, jnp.float32),
        delta=jnp.full((S,), DELTA, jnp.float32))

    def f(sm_stacked, u_st, b_st):
        sm = jpoisson._unstack(sm_stacked)
        return (sm.apply(b_st[0])[None], sm.smooth(u_st[0], b_st[0])[None],
                sm.residual(u_st[0], b_st[0])[None])

    mesh = Mesh(np.array(jax.devices()[:S]), (jpoisson.AXIS,))
    outs = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P(jpoisson.AXIS),) * 3,
        out_specs=(P(jpoisson.AXIS),) * 3, check_vma=False))(
            sm_st, jnp.asarray(jsharding.partition_axis0(u, n, p, S)),
            jnp.asarray(jsharding.partition_axis0(b, n, p, S)))
    return [np.asarray(o) for o in outs]


@pytest.mark.parametrize("degree,core,pairs", [
    (5, "mxu", True), (4, "mxu", True), (5, "banded", False),
    (5, "mxu", False)])
def test_sharded_fused_smoother_matches_jax(degree, core, pairs):
    """apply, smooth and residual of the port's ShardedFusedChebyshev
    against the JAX package's, Q4 r=3 S=4 (two-cell slabs): the
    production path (mxu single steps, B.2 xext pairs), an odd step count
    (a pair, then a single ``chebf`` step with its plane-0 correction),
    and single steps at both cores; every shard, and the duplicated planes
    consistent."""
    p, r, S = 4, 3, 4
    rng = np.random.default_rng(degree + pairs)
    sp = FESpace(HyperCubeMesh(3, r), p)
    m = sp.free_mask()
    u, b = ((rng.standard_normal(sp.grid_shape) * m).astype(np.float32)
            for _ in range(2))
    want = _jax_smoother(p, r, S, degree, core, pairs, u, b)
    devices = [CPU] * S
    sm = sharding.ShardedFusedChebyshev(
        degree=degree, op=_build_stacked_slab(sp, devices, torch.float32),
        op_smooth=_build_stacked_slab(sp, devices, torch.float32, core),
        theta=THETA, delta=DELTA,
        op_cheb2=_build_stacked_cheb2(sp, devices, torch.float32)
        if pairs else None)
    n = sp.mesh.cells_per_axis
    fu, fb = (sharding.shard(v, n, p, devices, torch.float32)
              for v in (u, b))
    tol = TOL["banded" if core == "banded" and not pairs else "mxu"]
    for got, w in zip((sm.apply(fb), sm.smooth(fu, fb), sm.residual(fu, fb)),
                      want):
        scale = np.abs(w).max()
        for s in range(S):
            np.testing.assert_allclose(got.parts[s].numpy(), w[s], rtol=0,
                                       atol=tol * scale)
        for s in range(S - 1):
            np.testing.assert_allclose(got.parts[s][-1], got.parts[s + 1][0],
                                       rtol=0, atol=1e-6 * scale)


def test_kernel_path_solve_matches_jax():
    """ShardedGeometricPoisson(3, 4, 3, S=4, float32, "auto") (the JAX
    package's "pallas"): the JAX package's sharded count, which equals its
    single-device float64 count, and x within 2e-5 max|x| of that
    solve's."""
    jx, jst = JPoisson(3, 4, 3, jnp.float64).solve(rtol=1e-5)
    x, st = ShardedGeometricPoisson(3, 4, 3, devices=[CPU] * 4,
                                    dtype=torch.float32,
                                    variant="auto").solve(rtol=1e-5)
    assert st.converged
    assert st.iterations == jst.iterations == JAX_SHARDED_PALLAS_ITERATIONS
    jx = np.asarray(jx)
    np.testing.assert_allclose(x, jx, rtol=0, atol=2e-5 * np.abs(jx).max())


def test_kernel_path_two_cell_slabs_s8():
    """S = 8 at r = 4 on the kernel path: two-cell slabs with B.2's xext
    pairs on the fine level, one-cell slabs with single chebf steps at
    r = 3; the single-device count at the same grade (float32 state) and
    x within 1e-5 max|x|."""
    x, st = ShardedGeometricPoisson(3, 2, 4, devices=[CPU] * 8,
                                    dtype=torch.float32,
                                    variant="auto").solve(rtol=1e-5)
    model = GeometricMultigridPoisson(3, 2, 4, torch.float32, "auto",
                                      device="cpu")
    for lvl in model.levels:
        if getattr(lvl.smoother, "state_dtype", None) is not None:
            lvl.smoother.state_dtype = None
    res = cg(model.fine_operator.apply, model.rhs(),
             model.preconditioner().apply, rtol=1e-5)
    assert st.converged and st.iterations == res.iterations
    x1 = res.x.numpy()
    np.testing.assert_allclose(x, x1, rtol=0, atol=1e-5 * np.abs(x1).max())


def _np_levels(model):
    return jax.tree_util.tree_map(np.asarray, model.levels_stacked)


@pytest.mark.parametrize("variant", ["sumfac", "kron"])
def test_convert_round_trips_plain_levels(variant):
    """convert.sharded_levels on the JAX model's levels (NumPy, leading
    shard axis): every array of every shard equal to the JAX one, and CG
    over the converted V-cycle gives the JAX solve's count and x (float64,
    Q2 r=3, S = 4)."""
    S = 4
    jm = jpoisson.ShardedGeometricPoisson(3, 2, 3, devices=jax.devices()[:S],
                                          variant=variant)
    jx, jst = jm.solve()
    jl = _np_levels(jm)
    levels = sharded_levels(jl, [CPU] * S, jm.n_replicated)
    for jlvl, lvl in zip(jl, levels):
        for s, loc in enumerate(lvl.op.local):
            for name in ("mask1", "dK1", "dM1", "Kg", "Mg"):
                jv = getattr(jlvl.op, name)
                if jv is not None:
                    for a, b in zip(getattr(loc, name), jv):
                        np.testing.assert_array_equal(a.numpy(), b[s])
        if lvl.transfer is not None:
            tr = getattr(lvl.transfer, "local", None)
            jtr = getattr(jlvl.transfer, "local", jlvl.transfer)
            np.testing.assert_array_equal(tr[0].M1.numpy(), jtr.M1[0])
        assert lvl.smoother.theta == float(jlvl.smoother.theta[0])
    n = 8
    w = [torch.from_numpy(v) for v in sharding.dot_weights_axis0(n, 2, S)]
    mg = VCycle(levels=levels)
    b = sharding.shard(assemble_rhs(FESpace(HyperCubeMesh(3, 3), 2)), n, 2,
                       [CPU] * S, torch.float64)
    res = cg(levels[-1].op.apply, b, mg.apply, rtol=1e-12,
             dot=sharding.make_sharded_dot(w, 3))
    assert res.iterations == jst.iterations
    x = sharding.unpartition_axis0(list(res.x.parts), n, 2, S).numpy()
    jx = np.asarray(jx)
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-10 * np.abs(jx).max())


def test_convert_kernel_levels():
    """The JAX model's kernel path (interpret mode), Q4 r=3 S=4: the
    converted levels carry B.1's slabs where JAX has its slab kernel (with
    the same per-shard factors and thin rows), the fused smoother with
    B.2's xext pairs where JAX has them, the JAX bounds; their V-cycle
    under CG gives the JAX package's sharded count."""
    S = 4
    jm = jpoisson.ShardedGeometricPoisson(
        3, 4, 3, devices=jax.devices()[:S], dtype=jnp.float32,
        variant="pallas", pallas_interpret=True)
    levels = sharded_levels(_np_levels(jm), [CPU] * S, jm.n_replicated,
                            torch.float32)
    fine = levels[-1]
    assert isinstance(fine.op, sharding.ShardedCudaLaplace)
    assert isinstance(fine.smoother, sharding.ShardedFusedChebyshev)
    assert fine.smoother.op_cheb2 is not None
    assert fine.smoother.op_smooth.local[0].core == "mxu"
    # JAX's slab needs two-cell slabs at p = 4: r = 2 runs kron there
    assert isinstance(levels[-2].op, sharding.ShardedLaplaceOperator)
    n, p = 8, 4
    w = [torch.from_numpy(v).float()
         for v in sharding.dot_weights_axis0(n, p, S)]
    b = sharding.shard(assemble_rhs(FESpace(HyperCubeMesh(3, 3), p)), n, p,
                       [CPU] * S, torch.float32)
    res = cg(fine.op.apply, b, VCycle(levels=levels).apply, rtol=1e-5,
             dot=sharding.make_sharded_dot(w, 3))
    assert res.converged and res.iterations == JAX_SHARDED_PALLAS_ITERATIONS
