"""The slab-sharded elasticity solve (``portable_multigrid_tpu_torch/
parallel/elasticity.py``) on the CPU: the plain sharded apply against the
single-device operator, the sharded dot, whole solves against the JAX
package's ``ShardedElasticity`` and the port's single-device
``ElasticityMultigrid``, ``convert.sharded_elasticity_levels`` on a JAX
level set, the constructor's errors and the no-JAX rule.  The port runs S
shards on ``[torch.device("cpu")] * S``.

The JAX package's whole sharded elasticity solves take from 30 s to
several minutes here (its tests/conftest.py marks both slow), so the
solves are held to their CG counts and L2 norms, pinned below from one
run each of (from the repository root, on the CPU)::

    python -c "import jax
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_num_cpu_devices', 8)
    jax.config.update('jax_enable_x64', True)
    import jax.numpy as jnp
    from portable_multigrid_tpu.parallel.elasticity import ShardedElasticity
    st = ShardedElasticity(3, 4, 2, devices=jax.devices()[:2],
                           dtype=jnp.float32, variant='pallas',
                           pallas_interpret=True,
                           pallas_zpad=0).solve(rtol=1e-5)[1]
    print(st.iterations, repr(st.solution_l2_norm))"

with the arguments of each row of :data:`JAX_SOLVES` (float64 solves at
the default rtol 1e-12, without ``dtype``; the ``"sumfac"`` one without
the ``pallas`` arguments) and of :data:`JAX_CONVERT_SOLVE` (``mu=0.7,
lam=1.3``, float64); and x against the port's single-device solve.
The JAX level set that ``convert`` reads is built once per module."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.parallel.elasticity import (
    ShardedElasticity as JShardedElasticity,
)
from portable_multigrid_tpu_torch import convert
from portable_multigrid_tpu_torch.fem.assemble import l2_norm
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.models.elasticity import ElasticityMultigrid
from portable_multigrid_tpu_torch.ops.elasticity import make_elasticity
from portable_multigrid_tpu_torch.parallel import sharding
from portable_multigrid_tpu_torch.parallel.elasticity import (
    ShardedElasticity,
    _build_stacked_elasticity,
    shard_vector,
    sharded_cuda_elasticity,
)
from portable_multigrid_tpu_torch.solvers.cg import cg
from portable_multigrid_tpu_torch.solvers.vcycle import VCycle

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
MU, LAM = 0.7, 1.3
# (dim, degree, refinements, S, variant, dtype) -> the JAX package's
# ShardedElasticity (CG iterations, L2 norm) at mu = lam = 1; "auto" is
# its "pallas"
JAX_SOLVES = {
    (3, 2, 2, 4, "sumfac", torch.float64): (4, 0.027343514900882566),
    (3, 4, 2, 2, "auto", torch.float32): (3, 0.027367313360876864),
    (3, 3, 3, 4, "auto", torch.float32): (3, 0.02736789487215654),
}
# the float64 "pallas" solve of the level set that convert reads, (3, 4,
# 2) on two shards at mu 0.7, lam 1.3
JAX_CONVERT_SOLVE = (6, 0.03419565621258934)
# the solves' rtol, their x against the single device's over max |x|, and
# their L2 norm against the JAX package's
RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
X_TOL = {torch.float64: 1e-10, torch.float32: 1e-5}
L2_TOL = {torch.float64: 1e-10, torch.float32: 1e-5}


@pytest.fixture(scope="module", autouse=True)
def _pmg_defaults():
    """Every PMG_* setting of both packages at its default; the
    single-device float32 solve at the exact grade."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("PMG_")]:
            mp.delenv(key)
        mp.setenv("PMG_ELASTICITY_MXU", "0")
        yield


@pytest.fixture(scope="module")
def jax_levels():
    """The JAX package's float64 level set of (3, 4, 2) on two shards,
    variant "pallas" in interpret mode: r = 1 a sumfac level (one-cell
    slabs), r = 2 its ShardedPallasElasticity."""
    return JShardedElasticity(3, 4, 2, mu=MU, lam=LAM,
                              devices=jax.devices()[:2], variant="pallas",
                              pallas_interpret=True,
                              pallas_zpad=0).levels_stacked


def _partitioned(x, n, p, S):
    """A global [dim, ...] field as per-shard [dim, N_loc, ...] arrays."""
    return [np.stack([sharding.partition_axis0(x[c], n, p, S)[s]
                      for c in range(x.shape[0])]) for s in range(S)]


@pytest.mark.parametrize("dim,variant,p,r,S", [
    (2, "sumfac", 3, 2, 4), (2, "kron", 3, 2, 4), (2, "sumfac", 2, 3, 2),
    (3, "sumfac", 2, 2, 4), (3, "kron", 2, 2, 4), (3, "sumfac", 3, 1, 2),
    (3, "kron", 1, 3, 8)])
def test_plain_apply_matches_single_device(dim, variant, p, r, S):
    """ShardedElasticityOperator.apply (each shard's operator on its masked
    slab, the halo sum along axis 1, the mask combine) against the
    single-device operator of the same variant within 1e-12, on vector
    fields, at two refinements of each dimension; the exchange runs along
    the grid axis, not the component axis (the JAX package's fault
    1f97bde)."""
    sp = FESpace(HyperCubeMesh(dim, r), p)
    n = sp.mesh.cells_per_axis
    u = np.random.default_rng(dim * 10 + r).standard_normal(
        (dim,) + sp.grid_shape)
    want = make_elasticity(sp, torch.float64, MU, LAM, variant).apply(
        torch.as_tensor(u)).numpy()
    op = _build_stacked_elasticity(sp, [CPU] * S, torch.float64, MU, LAM,
                                   variant)
    got = op.apply(shard_vector(u, n, p, [CPU] * S, torch.float64))
    scale = np.abs(want).max()
    for g, w in zip(got.parts, _partitioned(want, n, p, S)):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12 * scale)
    # and the kernel path's twin (3D) on the same field
    if dim == 3 and variant == "kron":
        got = sharded_cuda_elasticity(sp, [CPU] * S, torch.float64, MU,
                                      LAM).apply(
            shard_vector(u, n, p, [CPU] * S, torch.float64))
        for g, w in zip(got.parts, _partitioned(want, n, p, S)):
            np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                       atol=1e-12 * scale)


@pytest.mark.parametrize("dim,S", [(2, 4), (3, 2)])
def test_sharded_dot_matches_global(dim, S):
    """make_sharded_dot(lead_axes=1) on vector fields: the duplicated
    planes of every component weighted by 1/2, equal to the global dot."""
    sp = FESpace(HyperCubeMesh(dim, 2), 2)
    n, p = sp.mesh.cells_per_axis, sp.degree
    rng = np.random.default_rng(S)
    a, b = (rng.standard_normal((dim,) + sp.grid_shape) for _ in range(2))
    w = sharding.dot_weights_axis0(n, p, S)
    dot = sharding.make_sharded_dot([torch.as_tensor(v) for v in w], dim,
                                    lead_axes=1)
    got = float(dot(shard_vector(a, n, p, [CPU] * S, torch.float64),
                    shard_vector(b, n, p, [CPU] * S, torch.float64)))
    assert got == pytest.approx(float(np.vdot(a, b)), rel=1e-13)


@pytest.mark.parametrize("key", list(JAX_SOLVES), ids=lambda k: (
    f"{k[4]}-{str(k[5])[6:]}-q{k[1]}r{k[2]}s{k[3]}"))
def test_solve_matches_jax_and_single_device(key):
    """The sharded solve's CG count equals the JAX package's and its L2
    norm is within L2_TOL of it; x within X_TOL of max |x| of the port's
    single-device ElasticityMultigrid (kron in float64; the kernel twins
    in float32, at the exact grade), at the JAX package's mu = lam = 1.
    "auto" runs B.5's slab on every float32 level."""
    dim, p, r, S, variant, dtype = key
    model = ShardedElasticity(dim, p, r, devices=[CPU] * S, dtype=dtype,
                              variant=variant)
    kinds = {type(lvl.op).__name__ for lvl in model.levels}
    assert kinds == ({"ShardedCudaElasticity"} if variant == "auto"
                     else {"ShardedElasticityOperator"})
    x, st = model.solve(rtol=RTOL[dtype])
    iters, l2 = JAX_SOLVES[key]
    assert st.converged and st.iterations == iters
    assert st.solution_l2_norm == pytest.approx(l2, rel=L2_TOL[dtype])
    assert st.n_dofs == dim * (2 ** r * p + 1) ** dim
    single = ElasticityMultigrid(dim, p, r, dtype=dtype,
                                 variant="kron" if variant == "sumfac"
                                 else "auto", device="cpu")
    x1, st1 = single.solve(rtol=RTOL[dtype])
    x1 = x1.numpy()
    assert abs(st.iterations - st1.iterations) <= 1
    np.testing.assert_allclose(x, x1, rtol=0,
                               atol=X_TOL[dtype] * np.abs(x1).max())


def test_convert_round_trip(jax_levels):
    """convert.sharded_elasticity_levels on the JAX level set: r = 1 as
    the plain sumfac operator, r = 2 as B.5's slabs, each applying as the
    port's own level within 1e-12, the JAX bounds and degrees carried
    across; the converted hierarchy's float64 solve takes the JAX
    package's count, L2 within 1e-10."""
    levels = convert.sharded_elasticity_levels(jax_levels, [CPU] * 2,
                                               torch.float64)
    assert [type(lvl.op).__name__ for lvl in levels] == [
        "ShardedElasticityOperator", "ShardedCudaElasticity"]
    for lvl, jlvl, r in zip(levels, jax_levels, (1, 2)):
        sp = FESpace(HyperCubeMesh(3, r), 4)
        n = sp.mesh.cells_per_axis
        own = (_build_stacked_elasticity if r == 1
               else sharded_cuda_elasticity)(sp, [CPU] * 2, torch.float64,
                                             MU, LAM)
        u = np.random.default_rng(r).standard_normal((3,) + sp.grid_shape)
        want = own.apply(shard_vector(u, n, 4, [CPU] * 2, torch.float64))
        got = lvl.op.apply(shard_vector(u, n, 4, [CPU] * 2, torch.float64))
        scale = max(float(t.abs().max()) for t in want.parts)
        for g, w in zip(got.parts, want.parts):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-12 * scale)
        assert lvl.smoother.degree == int(jlvl.smoother.degree)
        assert lvl.smoother.theta == float(np.asarray(jlvl.smoother.theta)[0])
        assert lvl.smoother.delta == float(np.asarray(jlvl.smoother.delta)[0])
        assert (lvl.transfer is None) == (r == 1)
    model = ShardedElasticity(3, 4, 2, mu=MU, lam=LAM, devices=[CPU] * 2)
    fine = model.spaces[-1]
    w = sharding.dot_weights_axis0(fine.mesh.cells_per_axis, 4, 2)
    dot = sharding.make_sharded_dot([torch.as_tensor(v) for v in w], 3,
                                    lead_axes=1)
    res = cg(levels[-1].op.apply, model.rhs(), VCycle(levels=levels).apply,
             rtol=1e-12, dot=dot)
    x = model.gather(res.x)
    l2 = float(np.sqrt(sum(l2_norm(fine, x[c]) ** 2 for c in range(3))))
    iters, want_l2 = JAX_CONVERT_SOLVE
    assert res.converged and res.iterations == iters
    assert l2 == pytest.approx(want_l2, rel=1e-10)


def test_constructor_errors(monkeypatch):
    """The JAX class's errors: a shard count that is not a power of two,
    too few refinements for the shards, an unknown variant (JAX's
    "pallas" is the port's "auto"); and devices=None without a card."""
    with pytest.raises(ValueError, match="power of two"):
        ShardedElasticity(3, 2, 2, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="refinements"):
        ShardedElasticity(3, 2, 1, devices=[CPU] * 4)
    for variant in ("pallas", "kron"):
        with pytest.raises(ValueError, match="variant"):
            ShardedElasticity(3, 2, 2, devices=[CPU] * 2, variant=variant)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedElasticity(3, 2, 2)


def test_auto_2d_runs_sumfac():
    """A 2D "auto" solve builds no kernel, as the JAX package's, and
    matches the sumfac solve."""
    auto = ShardedElasticity(2, 2, 2, devices=[CPU] * 2, variant="auto")
    assert all(type(lvl.op).__name__ == "ShardedElasticityOperator"
               for lvl in auto.levels)
    x, st = auto.solve()
    x0, st0 = ShardedElasticity(2, 2, 2, devices=[CPU] * 2).solve()
    assert st.iterations == st0.iterations
    np.testing.assert_array_equal(x, x0)


def test_parallel_elasticity_imports_no_jax():
    """parallel/elasticity.py imports neither jax nor the JAX package: a
    child process imports it, and a grep of the source finds no such
    import."""
    code = ("import sys\n"
            "import portable_multigrid_tpu_torch.parallel.elasticity\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'portable_multigrid_tpu' or "
            "m.startswith('portable_multigrid_tpu.')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax\b|portable_multigrid_tpu"
                         r"\b(?!_torch))", re.M)
    src = ROOT / "portable_multigrid_tpu_torch" / "parallel" / "elasticity.py"
    assert not pattern.search(src.read_text())
