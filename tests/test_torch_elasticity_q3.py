"""The elasticity slice at Q3 (the degree of BASELINE config 4): the
port's ``ElasticityMultigrid`` against the JAX package's kron model in
float64 to rtol 1e-12 — 3D r=2 through the kron path and the kernel path
(twins on CPU), 2D r=2 through the kron path (the only 2D path) — and the
Q3 r=2 row of ``chip_smoke.py``'s pinned table.  The JAX solves run in
child processes, started when the module starts."""

import pytest
import torch

import chip_smoke
from portable_multigrid_tpu_torch import ElasticityMultigrid
from test_torch_elasticity_model import jax_solve_fixture, same_solve

torch.set_num_threads(1)

jax_q3 = jax_solve_fixture(3, 3, 2)
jax_2d = jax_solve_fixture(2, 3, 2)


def test_2d_kron_matches_jax(jax_2d):
    _, st = ElasticityMultigrid(2, 3, 2, dtype=torch.float64,
                                variant="kron", device="cpu").solve()
    same_solve(st, jax_2d.result()[0])


@pytest.mark.parametrize("variant", ["kron", "auto"])
def test_q3_matches_jax(jax_q3, variant):
    _, st = ElasticityMultigrid(3, 3, 2, dtype=torch.float64,
                                variant=variant, device="cpu").solve()
    same_solve(st, jax_q3.result()[0])


def test_pinned_row_matches_jax(jax_q3):
    jst = jax_q3.result()[0]
    iterations, l2 = chip_smoke.ELASTICITY_F64[(3, 2)]
    assert iterations == jst.iterations
    assert l2 == pytest.approx(jst.solution_l2_norm, rel=1e-12)
