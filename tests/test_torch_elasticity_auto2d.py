"""2D elasticity under ``variant="auto"``: the port falls back to ``kron``
on every level where B.5 (a 3D kernel) does not apply, as the JAX
package's ``make_elasticity_auto`` does, and gives the JAX package's
``"auto"`` solve: the CG count exactly and the L2 norm to 1e-10 (float64,
rtol 1e-12, mu = 0.7, lam = 1.3, on the CPU)."""

import os

import jax
import jax.numpy as jnp
import pytest
import torch

from portable_multigrid_tpu.models.elasticity import (
    ElasticityMultigrid as JElasticity,
)
from portable_multigrid_tpu_torch import ElasticityMultigrid

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _pmg_defaults():
    """Every PMG_* setting of both packages at its default."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("PMG_")]:
            mp.delenv(key)
        yield


MU, LAM = 0.7, 1.3


def test_2d_auto_solves_on_kron_with_the_jax_count():
    assert jax.default_backend() == "cpu"
    _, jst = JElasticity(2, 2, 2, mu=MU, lam=LAM, dtype=jnp.float64,
                         variant="auto").solve()
    prob = ElasticityMultigrid(2, 2, 2, mu=MU, lam=LAM, dtype=torch.float64,
                               variant="auto", device="cpu")
    assert all(lvl.op.variant == "kron" for lvl in prob.levels)
    _, st = prob.solve()
    assert st.converged and jst.converged
    assert st.iterations == jst.iterations
    assert st.n_dofs == jst.n_dofs
    assert st.solution_l2_norm == pytest.approx(jst.solution_l2_norm,
                                                rel=1e-10)
