"""The constant-coefficient operator variants ``sumfac`` and ``dense``
against the JAX package, on CPU, in float64.

* the port's ``make_laplace(..., "sumfac" | "dense")`` against JAX's
  ``make_laplace`` with the same variant and against ``dense_operator``, at
  the cases of the JAX package's ``test_variants_agree``, apply and inverse
  diagonal to 1e-12 relative;
* the same operators rebuilt by ``convert.laplace_operator`` from the JAX
  operator's state; the dense product's float32 difference form against
  the direct sum;
* solves on the plain variants: the golden table's CG counts and L2 norms,
  and ``MixedMultigridPoisson`` on ``sumfac`` against JAX's default
  (``sumfac``): CG count exact, x within 1e-10.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem.assemble import dense_operator
from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.models.mixed import (
    MixedMultigridPoisson as JMixed,
)
from portable_multigrid_tpu.ops.laplace import make_laplace as jmake_laplace
from portable_multigrid_tpu_torch import (
    GeometricMultigridPoisson,
    MixedMultigridPoisson,
    MixedPrecisionPoisson,
    PolynomialMultigridPoisson,
    convert,
)
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.laplace import LaplaceOperator, make_laplace
from portable_multigrid_tpu_torch.ops.structured import overlap_add_all, split_all
from portable_multigrid_tpu_torch.ops.transfer import Transfer
from portable_multigrid_tpu_torch.programs import geometric_multigrid
from portable_multigrid_tpu_torch.solvers.chebyshev import Chebyshev

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the cases of the JAX package's tests/test_operator.py::test_variants_agree
CASES = [(1, 3, 2), (2, 2, 2), (3, 2, 1), (3, 4, 1)]
VARIANTS = ["sumfac", "dense"]


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


def _spaces(dim, p, r):
    return JSpace(JMesh(dim, r), p), FESpace(HyperCubeMesh(dim, r), p)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dim,p,r", CASES)
def test_apply_matches_jax_and_dense(dim, p, r, variant):
    jsp, sp = _spaces(dim, p, r)
    u = np.random.default_rng(7).standard_normal(sp.grid_shape)
    jop = jmake_laplace(jsp, jnp.float64, variant)
    want = np.asarray(jop.apply(jnp.asarray(u)))
    dense = (dense_operator(jsp) @ u.reshape(-1)).reshape(sp.grid_shape)
    op = make_laplace(sp, torch.float64, variant)
    assert op.variant == variant
    got = op.apply(torch.as_tensor(u)).numpy()
    assert _rel(got, want) < 1e-12
    assert _rel(got, dense) < 1e-12
    np.testing.assert_allclose(op.inv_diag.numpy(), np.asarray(jop.inv_diag),
                               rtol=1e-12)
    np.testing.assert_allclose(1.0 / op.inv_diag.numpy().reshape(-1),
                               np.diag(dense_operator(jsp)), rtol=1e-12)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dim,p,r", [(2, 3, 2), (3, 2, 2)])
def test_convert_carries_the_state(dim, p, r, variant):
    """The port's operator rebuilt from the JAX operator's arrays applies
    as the JAX operator does."""
    jsp, sp = _spaces(dim, p, r)
    jop = jmake_laplace(jsp, jnp.float64, variant)
    a = lambda x: None if x is None else np.asarray(x)
    op = convert.laplace_operator(
        degree=p, n=jop.n[0], dim=dim, mask1=a(jop.mask1[0]), variant=variant,
        dK1=a(jop.dK1[0]), dM1=a(jop.dM1[0]), B=a(jop.B), Dco=a(jop.Dco),
        qmetric=a(jop.qmetric), elem_matrix=a(jop.elem_matrix))
    u = np.random.default_rng(3).standard_normal(sp.grid_shape)
    want = np.asarray(jop.apply(jnp.asarray(u)))
    assert _rel(op.apply(torch.as_tensor(u)).numpy(), want) < 1e-12
    np.testing.assert_allclose(op.inv_diag.numpy(), np.asarray(jop.inv_diag),
                               rtol=1e-13)


def test_float32_sumfac_matches_float64():
    """Full float32 on the CPU: the sumfac apply keeps f32 roundoff."""
    sp = FESpace(HyperCubeMesh(3, 2), 4)
    u = np.random.default_rng(1).standard_normal(sp.grid_shape)
    want = make_laplace(sp, torch.float64, "sumfac").apply(torch.as_tensor(u))
    got = make_laplace(sp, torch.float32, "sumfac").apply(
        torch.as_tensor(u, dtype=torch.float32))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want.numpy()) < 1e-5


def test_dense_float32_keeps_the_smooth_component():
    """The dense product in difference form, A_loc (u_e - u_e[0]), against
    the direct sum A_loc u_e, in float32 at Q4 r=4.  The element matrix
    annihilates constants only up to the rounding of its float32 entries,
    so the direct sum adds a spurious multiple of u that grows ~4x a
    refinement (~3e-6 of the float32 L2 norm at Q4 r=5 on the CPU).
    Measured along a smooth u (the energy u . A u, the component that sets
    a smooth solution's norm), the difference form sits within 1e-7 of
    float64 and at least 5x closer than the direct sum."""
    sp = FESpace(HyperCubeMesh(3, 4), 4)
    s = np.sin(np.pi * sp.dof_points_1d())
    u64 = torch.as_tensor(np.einsum("i,j,k->ijk", s, s, s))
    u32 = u64.float()
    op64 = make_laplace(sp, torch.float64, "dense")
    op32 = make_laplace(sp, torch.float32, "dense")
    energy = lambda au: float((u64 * au.double()).sum())
    e64 = energy(op64.apply(u64))
    diff = abs(energy(op32.apply(u32)) / e64 - 1)
    m = op32.mask
    flat = op32._to_elements(split_all(u32 * m, 3, op32.n, 4))
    au = overlap_add_all(op32._from_elements(flat @ op32.elem_matrix), 3,
                         op32.n, 4)
    direct = abs(energy(m * au + (1 - m) * u32) / e64 - 1)
    assert diff < 1e-7 and 5 * diff < direct


def _golden():
    with open(os.path.join(ROOT, "tests", "golden_convergence.json")) as fh:
        table = json.load(fh)
    return ({(r["degree"], r["refinements"]): r for r in table["geometric_3d"]},
            table["polynomial_2d"])


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("degree,refinements", [(2, 2), (4, 1)])
def test_geometric_golden_rows(degree, refinements, variant):
    """The plain variants run every level on full grids with plain
    Chebyshev and transfers, and give the golden CG counts and norms."""
    want = _golden()[0][(degree, refinements)]
    prob = GeometricMultigridPoisson(3, degree, refinements, torch.float64,
                                     variant, device="cpu")
    for lvl in prob.levels:
        assert type(lvl.op) is LaplaceOperator and lvl.op.variant == variant
        assert type(lvl.smoother) is Chebyshev
        assert lvl.transfer is None or type(lvl.transfer) is Transfer
    _, st = prob.solve()
    assert st.converged and st.iterations == want["iterations"]
    assert st.solution_l2_norm == pytest.approx(want["l2_norm"], rel=1e-10)


@pytest.mark.parametrize("variant", VARIANTS)
def test_polynomial_golden_row(variant):
    row = _golden()[1][2]  # 2D Q4 r=3, 4 levels
    _, st = PolynomialMultigridPoisson(2, row["degree"], row["refinements"],
                                       row["levels"], torch.float64, variant,
                                       device="cpu").solve()
    assert st.converged and st.iterations == row["iterations"]
    assert st.solution_l2_norm == pytest.approx(row["l2_norm"], rel=1e-10)


def test_mixed_sumfac_matches_jax_default():
    """Config 3 on the JAX package's default variant: the JAX solve's CG
    count exactly, x within 1e-10."""
    jx, jst = JMixed(2, 3, (1, 2, 4), jnp.float64).solve()
    x, st = MixedMultigridPoisson(2, 3, (1, 2, 4), torch.float64, "sumfac",
                                  device="cpu").solve()
    assert st.converged and st.iterations == jst.iterations
    jx = np.asarray(jx)
    assert np.abs(x.numpy() - jx).max() <= 1e-10 * np.abs(jx).max()


def test_mixed_precision_on_dense():
    """Config 5 on a plain variant: the float64 outer operator is that
    variant's, and the count is the all-float64 solve's."""
    prob = MixedPrecisionPoisson(2, 2, 3, torch.float32, "dense",
                                 device="cpu")
    assert prob.fine_operator.variant == "dense"
    assert prob.fine_operator.dtype == torch.float64
    _, st = prob.solve()
    _, s64 = GeometricMultigridPoisson(2, 2, 3, torch.float64, "dense",
                                       device="cpu").solve()
    assert st.converged and abs(st.iterations - s64.iterations) <= 2
    assert st.solution_l2_norm == pytest.approx(s64.solution_l2_norm,
                                                rel=1e-9)


def test_program_takes_the_variants(capsys):
    """The geometric-multigrid program runs sumfac and dense, as the JAX
    package's program's ``--variant`` does, with the kron counts and
    norms."""
    runs = {v: geometric_multigrid.main(["--max-degree", "1", "--cycles", "2",
                                         "--variant", v, "--device", "cpu"])
            for v in ("sumfac", "dense", "kron")}
    for v in ("sumfac", "dense"):
        assert [s.iterations for s in runs[v]] == [
            s.iterations for s in runs["kron"]]
        np.testing.assert_allclose([s.solution_l2_norm for s in runs[v]],
                                   [s.solution_l2_norm for s in runs["kron"]],
                                   rtol=1e-10)
    assert "Solver converged" in capsys.readouterr().out
