"""Port parity: every mode of the B.5 twin against the TPU kernel in
interpret mode on a 2x2 block grid (p = 2, n = 8, 4x4 blocks), where the
TPU kernel resolves its block overlaps with carry planes; the one-block
case and the rest of the operator tests are in
tests/test_torch_elasticity.py.

The file also holds the Q3 r=3 row of ``chip_smoke.py``'s pinned
elasticity table against the JAX package's live value (the card machine
has no JAX, so phase 9 of chip_smoke holds the kernels to these numbers).
That JAX solve at 46,875 DoFs compiles for ~25 s, so it runs in a child
process, started when the module starts, while the block-grid tests run.
"""

import pytest

import chip_smoke
from test_torch_elasticity import MODES, check_twin_matches_pallas_run
from test_torch_elasticity_model import jax_solve_fixture

jax_q3_r3 = jax_solve_fixture(3, 3, 3)


@pytest.mark.parametrize("mode", MODES)
def test_twin_matches_pallas_run_on_block_grid(mode):
    check_twin_matches_pallas_run(2, 3, 4, mode)


def test_pinned_row_matches_jax(jax_q3_r3):
    jst = jax_q3_r3.result()[0]
    assert jst.converged
    iterations, l2 = chip_smoke.ELASTICITY_F64[(3, 3)]
    assert iterations == jst.iterations
    assert l2 == pytest.approx(jst.solution_l2_norm, rel=1e-12)
    assert set(chip_smoke.ELASTICITY_F64) == {(2, 2), (3, 2), (3, 3)}
