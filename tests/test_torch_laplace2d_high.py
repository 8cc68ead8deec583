"""Port parity of the B.4 twin against ``PallasLaplace2D._run`` in
interpret mode at the higher degrees (p = 4 and 7), every mode, in float32
to 5e-6 relative; p = 1 and 2 and the rest of the operator's checks are in
tests/test_torch_laplace2d.py."""

import pytest
import torch

from test_torch_laplace2d import MODES, check_twin_matches_pallas_run

torch.set_num_threads(1)


# (p, r, bx) with at least two x blocks (p = 7 needs bx = 8, so r = 4)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,r,bx", [(4, 2, 2), (7, 4, 8)])
def test_twin_matches_pallas_run_high_degree(p, r, bx, mode):
    check_twin_matches_pallas_run(p, r, bx, mode)
