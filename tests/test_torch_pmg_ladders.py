"""p-ladders of the port against the JAX package's solve of the same ladder
at test time (``variant="sumfac"``, float64): CG counts exact, L2 to 1e-10.
The Q7 ladder is in tests/test_torch_pmg_q7.py; each JAX solve compiles
for 10-30 s on the CPU, so the ladders are spread over files."""

import pytest
import torch

from test_torch_pmg import check_ladder_matches_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("degree,levels,r", [(3, 3, 2), (5, 5, 2)])
def test_ladders_match_jax(degree, levels, r):
    check_ladder_matches_jax(degree, levels, r)
