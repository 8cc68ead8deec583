"""The bf16 smoother grade as the default of ``variant="auto"``, on the CPU.

On a float32 kernel level ``_build_level`` builds what the JAX package's
``_build_level`` builds (``portable_multigrid_tpu/models/poisson.py:46-131``):
the exact B.1 for CG, the eigenvalue estimate and the level residuals; the
``"mxu"`` B.1 for the recurrence's single steps; B.2 at its production
grade; r and d stored in bfloat16.  float64 levels keep the exact operator
in every role.  The bf16 grade leaves the CG history unchanged: the port's
config-5 solve at 3D Q4 r=2 (float32 V-cycle under float64 CG, the new
default) takes exactly the count of the JAX package's float32-V-cycle
baseline (``MixedPrecisionPoisson(3, 4, 2, mg_dtype=float32)``, the
baseline of ``tests/test_pallas_smoother.py`` and
``tests/test_pallas_cheb2.py``), with the L2 norm to 1e-7; the JAX package's
own bf16 swap of that solve is held in tests/test_torch_bf16_swap.py.
"""

import os

import jax.numpy as jnp
import pytest
import torch

from portable_multigrid_tpu.models.mixed import (
    MixedPrecisionPoisson as JMixedPrecision,
)
from portable_multigrid_tpu_torch import (
    GeometricMultigridPoisson,
    MixedMultigridPoisson,
    MixedPrecisionPoisson,
    PolynomialMultigridPoisson,
)
from portable_multigrid_tpu_torch.ops.cuda_cheb2 import make_cheb2
from portable_multigrid_tpu_torch.ops.cuda_laplace import CudaLaplaceOperator
from portable_multigrid_tpu_torch.ops.cuda_laplace2d import CudaLaplace2D
from portable_multigrid_tpu_torch.solvers.chebyshev import FusedChebyshev

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _pmg_defaults():
    """Every PMG_* setting of both packages at its default."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("PMG_")]:
            mp.delenv(key)
        yield


@pytest.fixture(scope="module")
def jax_baseline():
    _, st = JMixedPrecision(3, 4, 2, mg_dtype=jnp.float32).solve()
    return st


def fused_levels(prob):
    """The fused smoothing levels: every level above the coarsest, whose
    Chebyshev-as-solver is fused too, at the exact grade."""
    return [lvl for lvl in prob.levels[1:]
            if isinstance(lvl.smoother, FusedChebyshev)]


@pytest.mark.parametrize("model", ["geometric", "config3", "config5"])
def test_float32_auto_builds_the_jax_grade(model):
    prob = {
        "geometric": lambda: GeometricMultigridPoisson(
            3, 2, 2, torch.float32, "auto", "cpu"),
        "config3": lambda: MixedMultigridPoisson(
            3, 1, (1, 2), torch.float32, "auto", "cpu"),
        "config5": lambda: MixedPrecisionPoisson(
            3, 2, 2, torch.float32, "auto", "cpu"),
    }[model]()
    levels = fused_levels(prob)
    assert len(levels) == len(prob.levels) - 1  # all but the coarse solve
    for lvl in levels:
        sm = lvl.smoother
        assert type(lvl.op) is CudaLaplaceOperator and lvl.op.core == "banded"
        assert sm.op is lvl.op
        assert sm.op_smooth.core == "mxu"
        assert sm.op_smooth.degree == lvl.op.degree
        assert sm.op_cheb2.op is sm.op_smooth
        assert sm.state_dtype == torch.bfloat16


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_coarse_solve_is_fused_at_the_exact_grade(dim, dtype):
    """The coarsest level runs its Chebyshev-as-solver fused on its own
    operator, in its dtype: no bf16-grade operator, no bf16 state, no
    pair, in float32 as in float64."""
    prob = GeometricMultigridPoisson(dim, 2, 2, dtype, "auto", "cpu")
    coarse = prob.levels[0]
    sm = coarse.smoother
    assert isinstance(sm, FusedChebyshev) and sm.op is coarse.op
    assert sm.op.core == "banded"
    assert sm.op_smooth is None and sm.state_dtype is None
    assert sm.op_cheb2 is None


def test_float32_2d_auto_smooths_exact_at_bf16_state():
    prob = PolynomialMultigridPoisson(2, 3, 2, 3, torch.float32, "auto",
                                      "cpu")
    for lvl in fused_levels(prob):
        sm = lvl.smoother
        assert type(lvl.op) is CudaLaplace2D and sm.op_smooth is lvl.op
        assert sm.op_cheb2 is None and sm.state_dtype == torch.bfloat16


@pytest.mark.parametrize("dim", [2, 3])
def test_float64_auto_is_exact_in_every_role(dim):
    prob = GeometricMultigridPoisson(dim, 2, 2, torch.float64, "auto", "cpu")
    for lvl in fused_levels(prob):
        sm = lvl.smoother
        assert sm.op_smooth is None and sm.state_dtype is None
        assert sm.op_cheb2 is None or sm.op_cheb2.op is lvl.op


def test_mixed_precision_count_matches_the_jax_baseline(jax_baseline):
    prob = MixedPrecisionPoisson(3, 4, 2, torch.float32, "auto", "cpu")
    assert fused_levels(prob)[-1].smoother.state_dtype == torch.bfloat16
    _, st = prob.solve()
    assert st.converged and jax_baseline.converged
    assert st.iterations == jax_baseline.iterations
    assert st.solution_l2_norm == pytest.approx(
        jax_baseline.solution_l2_norm, rel=1e-7)


def test_float32_geometric_auto_q4_r2_count():
    """The float32 CG solve at the bf16 grade and at the exact grade (the
    fine smoothers swapped back to the exact operator at float32 state)
    take the same count and land on the same L2 norm to rtol's grade."""
    prob = GeometricMultigridPoisson(3, 4, 2, torch.float32, "auto", "cpu")
    _, st = prob.solve(rtol=1e-5)
    for lvl in fused_levels(prob):
        sm = lvl.smoother
        lvl.smoother = FusedChebyshev(
            degree=sm.degree, op=sm.op, theta=sm.theta, delta=sm.delta,
            op_cheb2=make_cheb2(sm.op))
    _, exact = prob.solve(rtol=1e-5)
    assert st.converged and st.iterations == exact.iterations
    assert st.solution_l2_norm == pytest.approx(exact.solution_l2_norm,
                                                rel=1e-5)
