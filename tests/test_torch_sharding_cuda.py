"""On-card checks of the sharded kernel path (marked ``requires_cuda``):
B.1's slab modes and B.2's xext pair against their twins on the first,
an interior and the last shard (float32, and B.1's exact slab in float64
too), every xext output equal to the single-device pair's bit for bit,
and sharded solves on one card against the single-device ones.  These
skip on a machine without a card; phase 16 of ``python3 chip_smoke.py``
runs them at the main path's shapes."""

import numpy as np
import pytest
import torch

import chip_smoke
from portable_multigrid_tpu_torch import GeometricMultigridPoisson
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_laplace import (
    cuda_laplace_slab_from_factors,
)
from portable_multigrid_tpu_torch.ops.laplace import (
    assembled_1d_matrices,
    diagonal_1d_factors,
)
from portable_multigrid_tpu_torch.parallel.poisson import (
    ShardedGeometricPoisson,
    _partial_assembled_1d,
)
from portable_multigrid_tpu_torch.parallel.sharding import partition_axis0

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("p", range(1, 8))
def test_sharded_modes_match_twins(cuda, p):
    """chip_smoke.sharded_compare: every slab and xext mode within its
    bound on shards 0, 1 and 3 of 4, and the xext pair's outputs the
    single-device pair's bit for bit."""
    same = chip_smoke.sharded_compare(p, 3, 4, (0, 1, 3), cuda, {})
    for grade in ("exact", "mxu"):
        assert same[grade, "bitwise"] == same[grade, "outputs"] > 0


@pytest.mark.parametrize("p", [1, 4, 7])
def test_float64_slab_matches_twin(cuda, p):
    """B.1's exact slab in float64 (the kernel's double instance), every
    mode, against its twin within 1e-12, on shards 0, 1 and 3 of 4."""
    sp = FESpace(HyperCubeMesh(3, 3), p)
    n, S = 8, 4
    K1, M1 = assembled_1d_matrices(sp)
    gK, gM = diagonal_1d_factors(sp)
    m1 = sp.free_mask_1d()
    Kp, Mp = _partial_assembled_1d(sp, n // S)
    rng = np.random.default_rng(p)
    for s in (0, 1, S - 1):
        mx, gKx, gMx = (partition_axis0(v, n, p, S)[s] for v in (m1, gK, gM))
        op = cuda_laplace_slab_from_factors(p, n, n // S, m1, K1, M1, gK, gM,
                                            mx, Kp, Mp, gKx, gMx,
                                            torch.float64, cuda)
        L, N, _ = op.trimmed_shape
        u = torch.as_tensor(rng.standard_normal((L + 1, N, N)),
                            device=cuda)
        r, x = (torch.as_tensor(rng.standard_normal((L, N, N)), device=cuda)
                for _ in range(2))
        for mode, ins, scal in (("apply", (), ()), ("residual1f", (r,), ()),
                                ("residual3f", (r,), (1.3,)),
                                ("chebf", (r, x), (0.59, 1.26))):
            got, want = op.run(mode, u, ins, scal), op.twin(mode, u, ins,
                                                            scal)
            for g, w in zip(got, want):
                assert float((g - w).abs().max()) <= 1e-12 * float(
                    w.abs().max())


@pytest.mark.parametrize("S,r", [(4, 3), (8, 4)])
def test_sharded_solve_on_one_card(cuda, S, r):
    """S shards on one card, float32, kernel path: the single-device count
    at float32 state, x within 1e-5 max|x|, the slab and xext modes
    launched."""
    st, launches, _ = chip_smoke.sharded_solve("card", [cuda] * S, 2, r,
                                               f"Q2 r={r} S={S}")
    assert st.converged
    assert launches["laplace"]["residual3f/slab"] > 0
    assert launches["cheb2"]["cheb2/xext/mxu"] > 0


def test_float64_plain_sharded_matches_single_device(cuda):
    x, st = ShardedGeometricPoisson(3, 2, 3, devices=[cuda] * 4).solve()
    x1, st1 = GeometricMultigridPoisson(3, 2, 3, torch.float64, "auto",
                                        device=cuda).solve()
    assert st.iterations == st1.iterations
    assert st.solution_l2_norm == pytest.approx(st1.solution_l2_norm,
                                                rel=1e-10)
