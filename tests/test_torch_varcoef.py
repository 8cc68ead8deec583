"""Variable coefficients, a(u, v) = ∫ c grad u . grad v (BASELINE config
4's variable-coefficient half), against the JAX package on CPU in float64.

* the ``sumfac``, ``qdense`` and ``qbanded`` operators against JAX's
  ``make_laplace(coefficient=...)`` with the same variant and against
  ``dense_operator_coefficient``, at the JAX package's own cases
  (tests/test_operator.py), apply and inverse diagonal to 1e-12 relative;
  ``qdense`` against ``sumfac`` at Q4 and Q7;
* ``qbanded``'s window contractions against the global stage matrices;
* the same operators rebuilt by ``convert.laplace_operator`` from the JAX
  operator's state;
* ``GeometricMultigridPoisson(2, 2, 3, coefficient=c)`` against JAX's on
  every ``PMG_VARCOEFF_VARIANT``: CG counts exact, x within 1e-10, and the
  levels it builds under ``"auto"``;
* the JAX package's errors for illegal variant and coefficient pairs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem.assemble import (
    assemble_rhs,
    dense_operator_coefficient as jdense_coefficient,
)
from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.models.poisson import (
    GeometricMultigridPoisson as JPoisson,
)
from portable_multigrid_tpu.ops.laplace import make_laplace as jmake_laplace
from portable_multigrid_tpu_torch import GeometricMultigridPoisson, convert
from portable_multigrid_tpu_torch.fem.assemble import (
    dense_operator_coefficient,
)
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.laplace import (
    LaplaceOperator,
    global_quad_matrices,
    make_laplace,
)
from portable_multigrid_tpu_torch.ops.structured import contract
from portable_multigrid_tpu_torch.ops.transfer import Transfer
from portable_multigrid_tpu_torch.solvers.chebyshev import Chebyshev

torch.set_num_threads(1)

VARIANTS = ["sumfac", "qdense", "qbanded"]


def _coef(*xs):
    """The coefficient of the JAX package's operator tests."""
    out = 1.0
    for x in xs:
        out = out + 0.3 * np.sin(3 * x)
    return out


def _coef_solve(*xs):
    """The coefficient of the JAX package's solve test (and of BASELINE
    config 4's variable-coefficient run in chip_smoke.py)."""
    out = 1.0
    for x in xs:
        out = out + 0.5 * np.sin(3 * x)
    return out


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _spaces(dim, p, r):
    return JSpace(JMesh(dim, r), p), FESpace(HyperCubeMesh(dim, r), p)


@pytest.mark.parametrize("dim,p,r", [(1, 3, 2), (2, 2, 2), (3, 2, 1)])
@pytest.mark.parametrize("variant", VARIANTS)
def test_matches_jax_and_dense(dim, p, r, variant):
    jsp, sp = _spaces(dim, p, r)
    A = dense_operator_coefficient(sp, _coef)
    np.testing.assert_array_equal(A, jdense_coefficient(jsp, _coef))
    jop = jmake_laplace(jsp, jnp.float64, variant, coefficient=_coef)
    op = make_laplace(sp, torch.float64, variant, coefficient=_coef)
    assert op.variant == variant
    u = np.random.default_rng(5).standard_normal(sp.grid_shape)
    got = op.apply(torch.as_tensor(u)).numpy()
    assert _rel(got, np.asarray(jop.apply(jnp.asarray(u)))) < 1e-12
    assert _rel(got.reshape(-1), A @ u.reshape(-1)) < 1e-12
    np.testing.assert_allclose(op.inv_diag.numpy(), np.asarray(jop.inv_diag),
                               rtol=1e-12)
    np.testing.assert_allclose(1.0 / op.inv_diag.numpy().reshape(-1),
                               np.diag(A), rtol=1e-12)


@pytest.mark.parametrize("dim,p,r", [(3, 4, 2), (2, 7, 3)])
def test_qdense_matches_sumfac(dim, p, r):
    """At the degrees the dense oracle cannot reach: the port's qdense and
    sumfac against each other and JAX's qdense."""
    jsp, sp = _spaces(dim, p, r)
    u = np.random.default_rng(11).standard_normal(sp.grid_shape)
    want = np.asarray(jmake_laplace(jsp, jnp.float64, "qdense",
                                    coefficient=_coef).apply(jnp.asarray(u)))
    ut = torch.as_tensor(u)
    q = make_laplace(sp, torch.float64, "qdense", coefficient=_coef).apply(ut)
    s = make_laplace(sp, torch.float64, "sumfac", coefficient=_coef).apply(ut)
    assert _rel(q.numpy(), want) < 1e-12
    assert _rel(q.numpy(), s.numpy()) < 1e-12


def test_qbanded_stages_are_the_global_matrices():
    """Bg is a window split then B, Bg^T is B^T then the overlap-add, and
    Dg is Dco per cell: the qbanded apply equals the JAX package's global
    form Bg^T (sum_d Dg^T W Dg) Bg."""
    sp = FESpace(HyperCubeMesh(2, 2), 3)
    op = make_laplace(sp, torch.float64, "qbanded", coefficient=_coef)
    Bg, Dg = (torch.as_tensor(m) for m in global_quad_matrices(sp))
    u = torch.as_tensor(np.random.default_rng(2).standard_normal(
        sp.grid_shape)) * op.mask
    v = contract(contract(u, Bg, 0), Bg, 1)
    nq = op.B.shape[0]
    w = (op.qmetric.reshape(1, nq, 1, nq)
         * op.coef.reshape(op.n[0], nq, op.n[1], nq)).reshape(op.coef.shape)
    r = sum(contract(contract(v, Dg, d) * w, Dg.T, d) for d in range(2))
    want = contract(contract(r, Bg.T, 0), Bg.T, 1)
    assert _rel(op.apply_bilinear(u).numpy(), want.numpy()) < 1e-13


@pytest.mark.parametrize("variant", VARIANTS)
def test_convert_carries_the_state(variant):
    jsp, sp = _spaces(3, 2, 2)
    jop = jmake_laplace(jsp, jnp.float64, variant, coefficient=_coef)
    a = lambda x: None if x is None else np.asarray(x)
    op = convert.laplace_operator(
        degree=2, n=jop.n[0], dim=3, mask1=a(jop.mask1[0]), variant=variant,
        B=a(jop.B), Dco=a(jop.Dco), qmetric=a(jop.qmetric), coef=a(jop.coef),
        inv_diag_full=a(jop.inv_diag_full), Gmat=a(jop.Gmat),
        wcoef_e=a(jop.wcoef_e))
    u = np.random.default_rng(4).standard_normal(sp.grid_shape)
    want = np.asarray(jop.apply(jnp.asarray(u)))
    assert _rel(op.apply(torch.as_tensor(u)).numpy(), want) < 1e-12
    np.testing.assert_array_equal(op.inv_diag.numpy(),
                                  np.asarray(jop.inv_diag))


@pytest.mark.parametrize("variant", VARIANTS)
def test_solve_matches_jax(monkeypatch, variant):
    """The JAX package's tests/test_solvers.py solve on each variant: the
    CG count exactly, x within 1e-10 of JAX's, and the dense solve."""
    monkeypatch.setenv("PMG_VARCOEFF_VARIANT", variant)
    jx, jst = JPoisson(2, 2, 3, coefficient=_coef_solve).solve()
    prob = GeometricMultigridPoisson(2, 2, 3, torch.float64, "auto",
                                     device="cpu", coefficient=_coef_solve)
    x, st = prob.solve()
    assert st.converged and jst.converged and st.iterations <= 10
    assert st.iterations == jst.iterations
    jx = np.asarray(jx)
    assert np.abs(x.numpy() - jx).max() <= 1e-10 * np.abs(jx).max()
    jsp = JSpace(JMesh(2, 3), 2)
    want = np.linalg.solve(jdense_coefficient(jsp, _coef_solve),
                           assemble_rhs(jsp).reshape(-1))
    assert _rel(x.numpy().reshape(-1), want) < 1e-9


@pytest.mark.parametrize("dim", [2, 3])
def test_levels_follow_what_they_are(monkeypatch, dim):
    """With a coefficient every level, under the model's "auto" too, is a
    plain operator on the full grid: plain Chebyshev, the plain windowed
    transfer (never B.3, never a trimmed adapter), and a coarse level that
    rediscretizes the coefficient."""
    monkeypatch.delenv("PMG_VARCOEFF_VARIANT", raising=False)
    prob = GeometricMultigridPoisson(dim, 2, 2, torch.float64, "auto",
                                     device="cpu", coefficient=_coef_solve)
    assert not prob.fine_trimmed
    for lvl, sp in zip(prob.levels, prob.spaces):
        assert type(lvl.op) is LaplaceOperator and lvl.op.variant == "qdense"
        assert type(lvl.smoother) is Chebyshev
        assert lvl.transfer is None or type(lvl.transfer) is Transfer
        want = make_laplace(sp, torch.float64, "sumfac",
                            coefficient=_coef_solve).inv_diag
        torch.testing.assert_close(lvl.op.inv_diag, want, rtol=1e-14, atol=0)


def test_environment_picks_the_variant(monkeypatch):
    monkeypatch.setenv("PMG_VARCOEFF_VARIANT", "sumfac")
    prob = GeometricMultigridPoisson(2, 2, 1, torch.float64, "kron",
                                     device="cpu", coefficient=_coef)
    assert {lvl.op.variant for lvl in prob.levels} == {"sumfac"}
    monkeypatch.setenv("PMG_VARCOEFF_VARIANT", "dense")
    with pytest.raises(ValueError, match="require the 'sumfac'"):
        GeometricMultigridPoisson(2, 2, 1, torch.float64, "auto",
                                  device="cpu", coefficient=_coef)


@pytest.mark.parametrize("variant", ["dense", "kron", "bkron"])
def test_coefficient_variant_errors_are_jax_errors(variant):
    """A coefficient on a variant without q-point weights raises the JAX
    package's error, word for word."""
    jsp, sp = _spaces(2, 2, 1)
    with pytest.raises(ValueError) as jerr:
        jmake_laplace(jsp, jnp.float64, variant, coefficient=_coef)
    with pytest.raises(ValueError) as err:
        make_laplace(sp, torch.float64, variant, coefficient=_coef)
    assert str(err.value) == str(jerr.value)


def test_auto_with_a_coefficient_is_qdense():
    sp = FESpace(HyperCubeMesh(2, 1), 2)
    assert make_laplace(sp, variant="auto", coefficient=_coef).variant == \
        "qdense"


@pytest.mark.parametrize("variant", ["qdense", "qbanded"])
def test_q_variants_need_a_coefficient(variant):
    sp = FESpace(HyperCubeMesh(2, 1), 2)
    with pytest.raises(ValueError, match="needs a coefficient"):
        make_laplace(sp, torch.float64, variant)
    with pytest.raises(ValueError, match="needs a coefficient"):
        GeometricMultigridPoisson(2, 2, 1, torch.float64, variant,
                                  device="cpu")
