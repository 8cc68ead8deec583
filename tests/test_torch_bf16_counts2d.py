"""2D CG counts at the bf16 grade, on the CPU: the port's float32
``variant="auto"`` solves (B.4 at bfloat16 state on every smoothing
level; the fused coarse solve keeps float32 state)
take the counts that tests/test_pallas2d.py:126-172 pin for the JAX
package's fused 2D levels — those of its float32 ``sumfac`` solve, to rtol
1e-5 — with the L2 norm to 1e-5, on the 2D Q4 r=2 p-ladder and the 2D Q2
r=2 geometric hierarchy.
"""

import os

import jax.numpy as jnp
import pytest
import torch

from portable_multigrid_tpu.models.poisson import (
    GeometricMultigridPoisson as JGeometric,
    PolynomialMultigridPoisson as JPolynomial,
)
from portable_multigrid_tpu_torch import (
    GeometricMultigridPoisson,
    PolynomialMultigridPoisson,
)
from portable_multigrid_tpu_torch.solvers.chebyshev import FusedChebyshev

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _pmg_defaults():
    """Every PMG_* setting of both packages at its default."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("PMG_")]:
            mp.delenv(key)
        yield


CASES = {
    "polynomial": (JPolynomial, PolynomialMultigridPoisson, (2, 4, 2)),
    "geometric": (JGeometric, GeometricMultigridPoisson, (2, 2, 2)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_2d_auto_counts_at_bf16_state(name):
    jmodel, model, args = CASES[name]
    _, want = jmodel(*args, dtype=jnp.float32, variant="sumfac").solve(
        rtol=1e-5)
    prob = model(*args, dtype=torch.float32, variant="auto", device="cpu")
    fused = [lvl.smoother for lvl in prob.levels[1:]
             if isinstance(lvl.smoother, FusedChebyshev)]
    assert fused and all(sm.state_dtype == torch.bfloat16 for sm in fused)
    _, st = prob.solve(rtol=1e-5)
    assert st.converged and want.converged
    assert st.iterations == want.iterations
    assert st.solution_l2_norm == pytest.approx(want.solution_l2_norm,
                                                rel=1e-5)
