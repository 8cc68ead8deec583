"""The extended-domain sharded solve (``parallel/extended.py``) and the
entry points' twin (``graft_entry.py``) against the JAX package.

* The helpers ``_ext_mask0``, ``_ext_axis0_level``,
  ``_dense_coarse_bounds`` and ``_ext_operator.apply`` against the JAX
  functions, float64, to 1e-12.
* ``ExtendedShardedPoisson(3, 2, 2)`` and ``(3, 4, 2)`` on three CPU
  shards against the JAX class on three of the conftest's virtual CPU
  devices: the same CG count (at Q4 5, where the single device takes 4:
  the hierarchy stops at S cells), the live solution to 1e-10 relative.
* S = 6 at r = 3 against the port's single-device ``kron`` solve, with the
  bars of the JAX package's ``tests/test_sharding.py:364-392``: at most 2
  CG iterations more, L2 to 1e-9 relative, x to 1e-9 of max.
* ``dryrun_multichip(3)`` on the CPU, and the structure of ``entry()``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.parallel import extended as jext
from portable_multigrid_tpu_torch import graft_entry
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.models.poisson import (
    GeometricMultigridPoisson,
)
from portable_multigrid_tpu_torch.parallel import extended
from portable_multigrid_tpu_torch.parallel.extended import (
    ExtendedShardedPoisson,
)
from portable_multigrid_tpu_torch.solvers.chebyshev import FusedChebyshev

torch.set_num_threads(1)

CPU = torch.device("cpu")
# (dim, p, r, n0): extended x lattices of 3 and 6 shards' levels
LATTICES = [(3, 2, 1, 3), (3, 2, 2, 6), (2, 3, 1, 3), (3, 1, 2, 6),
            (2, 2, 3, 12)]


def _spaces(dim, p, r):
    return FESpace(HyperCubeMesh(dim, r), p), JSpace(JMesh(dim, r), p)


@pytest.mark.parametrize("dim,p,r,n0", LATTICES)
def test_helpers_equal_jax(dim, p, r, n0):
    sp, jsp = _spaces(dim, p, r)
    live = sp.mesh.cells_per_axis
    np.testing.assert_array_equal(extended._ext_mask0(n0, live, p),
                                  jext._ext_mask0(n0, live, p))
    for got, want in zip(extended._ext_axis0_level(sp, n0),
                         jext._ext_axis0_level(jsp, n0)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                   atol=1e-12 * np.abs(want).max())
    got = extended._dense_coarse_bounds(sp, n0)
    want = jext._dense_coarse_bounds(jsp, n0)
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("dim,p,r,n0", LATTICES)
def test_ext_operator_apply_equals_jax(dim, p, r, n0):
    """The single-device twin on the extended grid, applied to a seeded
    field that is nonzero on the dead region and the Dirichlet planes."""
    sp, jsp = _spaces(dim, p, r)
    op = extended._ext_operator(sp, n0, torch.float64)
    jop = jext._ext_operator(jsp, n0, jnp.float64)
    assert op.shape == tuple(jop.grid_shape)
    u = np.random.default_rng(n0 + p).standard_normal(op.shape)
    want = np.asarray(jop.apply(jnp.asarray(u)))
    got = op.apply(torch.as_tensor(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    np.testing.assert_allclose(op.inv_diag.numpy(),
                               np.asarray(jop.inv_diag), rtol=1e-12)


@pytest.mark.parametrize("p,r", [(2, 2), (4, 2)])
def test_s3_solve_matches_jax(p, r):
    """S = 3: the JAX class on 3 virtual devices and the port on 3 CPU
    shards give the same CG count and live solution."""
    jx, jst = jext.ExtendedShardedPoisson(
        3, p, r, devices=jax.devices()[:3], dtype=jnp.float64).solve(
            rtol=1e-10)
    prob = ExtendedShardedPoisson(3, p, r, devices=[CPU] * 3)
    x, st = prob.solve(rtol=1e-10)
    assert st.converged and st.iterations == jst.iterations
    assert x.shape == np.asarray(jx).shape == prob.spaces[-1].grid_shape
    jx = np.asarray(jx)
    assert np.abs(x - jx).max() <= 1e-10 * np.abs(jx).max()
    assert st.solution_l2_norm == pytest.approx(jst.solution_l2_norm,
                                                rel=1e-10)
    assert (st.n_dofs, st.n_shards, st.dofs_per_level) == (
        jst.n_dofs, jst.n_shards, jst.dofs_per_level)
    assert prob.n0s == [3 << j for j in range(r)]


def test_s6_solve_matches_single_device():
    """S = 6 at Q2 r=3 (extended axis 12 cells, 8 live) against the port's
    single-device kron solve, as the JAX package's test holds its own."""
    x, st = ExtendedShardedPoisson(3, 2, 3, devices=[CPU] * 6).solve(
        rtol=1e-10)
    x1, st1 = GeometricMultigridPoisson(3, 2, 3, torch.float64, "kron",
                                        CPU).solve(rtol=1e-10)
    x1 = x1.numpy()
    assert st.converged and st.iterations <= st1.iterations + 2
    assert st.solution_l2_norm == pytest.approx(st1.solution_l2_norm,
                                                rel=1e-9)
    assert np.abs(x - x1.reshape(x.shape)).max() <= 1e-9 * np.abs(x1).max()


def test_levels_and_verbose_lines(capsys):
    """The hierarchy bottoms out at S cells with one cell a shard, every
    level a multiple of S cells, and the verbose solve prints the JAX
    package's lines."""
    prob = ExtendedShardedPoisson(3, 2, 2, devices=[CPU] * 3)
    for sp, n0, lvl in zip(prob.spaces, prob.n0s, prob.levels):
        assert n0 % 3 == 0 and n0 >= sp.mesh.cells_per_axis
        assert all(loc.n[0] == n0 // 3 for loc in lvl.op.local)
    prob.solve(rtol=1e-10, verbose=True)
    out = capsys.readouterr().out.splitlines()
    assert out[0] == (" 729 live DoFs over 3 shards (extended axis: 6 "
                      "cells, live 4)")
    assert out[1].startswith("  Solver converged in ")
    assert out[2].startswith("  solution norm: 0.0250")


def test_too_few_refinements_refused():
    with pytest.raises(ValueError, match="need >= 2 refinements"):
        ExtendedShardedPoisson(3, 2, 1, devices=[CPU] * 6)


def test_dryrun_multichip_3(capsys):
    runs = graft_entry.dryrun_multichip(3, CPU)
    out = capsys.readouterr().out
    assert out.startswith("dryrun_multichip(3): 1D mesh — 729 DoFs over 3 "
                          "shards, ")
    assert set(runs) == {"1d", "1d_size"} and runs["1d_size"] == (2, 2)
    st = runs["1d"]
    assert st.converged and st.n_shards == 3 and st.n_dofs == 729
    _, st1 = GeometricMultigridPoisson(3, 2, 2, torch.float64, "kron",
                                       CPU).solve(rtol=1e-10)
    assert st.iterations <= st1.iterations + 2
    assert abs(st.solution_l2_norm - st1.solution_l2_norm) <= (
        1e-9 * st1.solution_l2_norm)


def test_entry_builds_the_production_vcycle():
    """entry()'s hierarchy on the CPU (not applied: one V-cycle of 2.1M
    DoFs on the twins takes ~20 s here; the card applies it): Q4 r=5, the
    fused smoother on trimmed state above the coarsest level with the mxu
    core for its recurrence, the rhs masked."""
    fn, (mg, rhs) = graft_entry.entry(CPU)
    assert mg.fine_trimmed and len(mg.levels) == 6
    assert tuple(rhs.shape) == (129,) * 3 and rhs.dtype == torch.float32
    assert float(rhs[0].abs().max()) == 0.0
    for lvl in mg.levels[1:]:
        assert isinstance(lvl.smoother, FusedChebyshev)
        assert lvl.smoother.trimmed_io and lvl.smoother.op_smooth.core == "mxu"
    assert mg.levels[0].smoother.degree == 16
