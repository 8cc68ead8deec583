"""Elasticity's ``sumfac`` and ``dense`` variants against the JAX package,
on CPU, in float64, with mu = 0.7, lam = 1.3 (at mu = lam a swap of the
gradient tensor's indices, or of mu and lam, leaves the operator
unchanged).

* apply and inverse diagonal against JAX's ``make_elasticity`` with the
  same variant and against ``dense_elasticity_operator``, at the cases of
  the JAX package's tests/test_elasticity.py, to 1e-12 relative;
* the operators rebuilt by ``convert.elasticity_operator`` from the JAX
  operator's state;
* ``ElasticityMultigrid`` on both variants: the kron path's CG count (held
  to the JAX package's in tests/test_torch_elasticity_model.py) and the
  JAX package's pinned float64 row; the ``variant=None`` rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.ops.elasticity import (
    dense_elasticity_operator as jdense,
    make_elasticity as jmake_elasticity,
)
from portable_multigrid_tpu_torch import ElasticityMultigrid, convert
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.elasticity import make_elasticity
from portable_multigrid_tpu_torch.ops.laplace import diagonal_1d_factors
from portable_multigrid_tpu_torch.ops.transfer import Transfer
from portable_multigrid_tpu_torch.solvers.chebyshev import Chebyshev

torch.set_num_threads(1)

MU, LAM = 0.7, 1.3
VARIANTS = ["sumfac", "dense"]
# the cases of the JAX package's tests/test_elasticity.py
CASES = [(2, 1, 2), (2, 2, 2), (3, 2, 1), (3, 3, 1)]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _spaces(dim, p, r):
    return JSpace(JMesh(dim, r), p), FESpace(HyperCubeMesh(dim, r), p)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dim,p,r", CASES)
def test_apply_matches_jax_and_dense(dim, p, r, variant):
    jsp, sp = _spaces(dim, p, r)
    u = np.random.default_rng(0).standard_normal((dim,) + sp.grid_shape)
    jop = jmake_elasticity(jsp, jnp.float64, mu=MU, lam=LAM, variant=variant)
    op = make_elasticity(sp, torch.float64, MU, LAM, variant)
    assert op.variant == variant
    got = op.apply(torch.as_tensor(u)).numpy()
    assert _rel(got, np.asarray(jop.apply(jnp.asarray(u)))) < 1e-12
    A = jdense(jsp, mu=MU, lam=LAM)
    assert _rel(got.reshape(-1), A @ u.reshape(-1)) < 1e-12
    np.testing.assert_allclose(op.inv_diag.numpy(), np.asarray(jop.inv_diag),
                               rtol=1e-12)


@pytest.mark.parametrize("variant", VARIANTS)
def test_convert_carries_the_state(variant):
    jsp, sp = _spaces(3, 2, 2)
    jop = jmake_elasticity(jsp, jnp.float64, mu=MU, lam=LAM, variant=variant)
    dK1, dM1 = diagonal_1d_factors(sp)
    a = lambda x: None if x is None else np.asarray(x)
    op = convert.elasticity_operator(
        degree=2, n=jop.n[0], dim=3, mask1=np.asarray(jop.mask)[:, 1, 1],
        dK1=dK1, dM1=dM1, mu=jop.mu, lam=jop.lam, variant=variant,
        B=a(jop.B), Dco=a(jop.Dco), qmetric=a(jop.qmetric),
        elem_matrix=a(jop.elem_matrix))
    u = np.random.default_rng(6).standard_normal((3,) + sp.grid_shape)
    want = np.asarray(jop.apply(jnp.asarray(u)))
    assert _rel(op.apply(torch.as_tensor(u)).numpy(), want) < 1e-12
    np.testing.assert_allclose(op.inv_diag.numpy(), np.asarray(jop.inv_diag),
                               rtol=1e-12)


def test_float32_sumfac_matches_float64():
    sp = FESpace(HyperCubeMesh(3, 2), 3)
    u = np.random.default_rng(1).standard_normal((3,) + sp.grid_shape)
    want = make_elasticity(sp, torch.float64, MU, LAM, "sumfac").apply(
        torch.as_tensor(u))
    got = make_elasticity(sp, torch.float32, MU, LAM, "sumfac").apply(
        torch.as_tensor(u, dtype=torch.float32))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want.numpy()) < 1e-5


@pytest.mark.parametrize("dim,p,r", [(2, 3, 2), (3, 2, 2)])
def test_solve_equals_kron(dim, p, r):
    """The plain variants solve with the kron path's CG count, L2 norm to
    1e-10 and x to 1e-10, on full grids with plain smoothers and
    transfers."""
    runs = {}
    for variant in ["kron"] + VARIANTS:
        prob = ElasticityMultigrid(dim, p, r, MU, LAM, torch.float64, variant,
                                   device="cpu")
        for lvl in prob.levels:
            assert lvl.op.variant == variant
            assert type(lvl.smoother) is Chebyshev
            assert lvl.transfer is None or type(lvl.transfer) is Transfer
        runs[variant] = prob.solve()
    xk, sk = runs["kron"]
    for variant in VARIANTS:
        x, st = runs[variant]
        assert st.converged and st.iterations == sk.iterations
        assert st.solution_l2_norm == pytest.approx(sk.solution_l2_norm,
                                                    rel=1e-10)
        assert _rel(x.numpy(), xk.numpy()) < 1e-10


@pytest.mark.parametrize("variant", VARIANTS)
def test_pinned_jax_row(variant):
    """The JAX package's float64 Q2 r=2 solve (mu = lam = 1), pinned in
    chip_smoke.py: its CG count exactly, its L2 norm to 1e-10."""
    iterations, l2 = chip_smoke.ELASTICITY_F64[(2, 2)]
    _, st = ElasticityMultigrid(3, 2, 2, dtype=torch.float64, variant=variant,
                                device="cpu").solve()
    assert st.converged and st.iterations == iterations
    assert st.solution_l2_norm == pytest.approx(l2, rel=1e-10)


def test_default_variant_rule(monkeypatch):
    """variant=None: PMG_ELASTICITY_VARIANT, else kron off the card (and
    in float64); the environment names any variant."""
    monkeypatch.delenv("PMG_ELASTICITY_VARIANT", raising=False)
    for dtype in (torch.float32, torch.float64):
        prob = ElasticityMultigrid(3, 1, 1, dtype=dtype, device="cpu")
        assert prob.variant == "kron"
    monkeypatch.setenv("PMG_ELASTICITY_VARIANT", "sumfac")
    prob = ElasticityMultigrid(2, 1, 1, device="cpu")
    assert prob.variant == "sumfac"
    assert {lvl.op.variant for lvl in prob.levels} == {"sumfac"}
