"""The Q7 4-level p-ladder at r=2 against the JAX package's solve of it at
test time (``variant="sumfac"``, float64): CG counts exact, L2 to 1e-10
(see tests/test_torch_pmg_ladders.py for the lower degrees)."""

import torch

from test_torch_pmg import check_ladder_matches_jax

torch.set_num_threads(1)


def test_q7_ladder_matches_jax():
    check_ladder_matches_jax(7, 4, 2)
