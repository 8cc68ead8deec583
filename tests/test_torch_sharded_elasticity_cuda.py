"""On-card checks of the sharded elasticity kernel path (marked
``requires_cuda``): B.5's slab ``apply`` against its twin in float32 and
float64 on the first, an interior and the last shard, and the sharded
solve as four shards on one card against the single-device solve.  These
skip on a machine without a card; phase 18 of ``python3 chip_smoke.py``
runs them at the Q3 r=6 solve's shapes."""

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p", range(1, 8))
def test_slab_matches_twin(cuda, p, dtype):
    """chip_smoke.elasticity_slab_compare: B.5's slab within BOUND of its
    twin on shards 0, 1 and 3 of 4 at r = 3."""
    errs = {}
    chip_smoke.elasticity_slab_compare(p, 3, 4, (0, 1, 3), dtype, cuda, errs)
    assert errs


def test_sharded_solve_on_one_card(cuda):
    """ShardedElasticity(3, 3, 3) on four shards of one card, float32,
    "auto": B.5's slab alone launched, converged within one CG iteration
    of the single-device exact-grade solve, L2 within
    F32_L2_BOUND_ELASTICITY."""
    st, launches, _ = chip_smoke.sharded_elasticity_solve(
        "", [cuda] * 4, 3, 3, "ShardedElasticity(3, 3, 3, 4 shards)")
    assert st.converged and set(launches) == {"apply/slab"}
