"""On-card checks of the 2D-pencil kernel path (marked ``requires_cuda``):
B.1's pencil ``apply`` and B.2's pencil pair against their twins on
pencils of the (2, 2) and (4, 2) meshes (float32, and B.1's pencil in
float64 too), every pair output equal to the single-device pair's bit for
bit, and pencil solves on one card against the single-device ones.  These
skip on a machine without a card; phase 17 of ``python3 chip_smoke.py``
runs them at the main path's shapes."""

import numpy as np
import pytest
import torch

import chip_smoke
from portable_multigrid_tpu_torch import GeometricMultigridPoisson
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_laplace import (
    cuda_laplace_pencil_from_factors,
)
from portable_multigrid_tpu_torch.ops.laplace import (
    assembled_1d_matrices,
    diagonal_1d_factors,
)
from portable_multigrid_tpu_torch.parallel.mesh2d import (
    Sharded2DGeometricPoisson,
    _pencil_factors,
)
from portable_multigrid_tpu_torch.parallel.poisson import _partial_assembled_1d

pytestmark = pytest.mark.requires_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("p", range(1, 8))
@pytest.mark.parametrize("mesh,shards", [((2, 2), (0, 3)), ((4, 2), (2, 5))])
def test_pencil_modes_match_twins(cuda, p, mesh, shards):
    """chip_smoke.sharded_compare on the pencil cases: B.1's pencil apply
    and every pencil pair mode within its bound, and the pair's outputs
    the single-device pair's bit for bit."""
    same = chip_smoke.sharded_compare(p, 3, mesh, shards, cuda, {},
                                      cases=chip_smoke.pencil_cases)
    for grade in ("exact", "mxu"):
        assert same[grade, "bitwise"] == same[grade, "outputs"] > 0


@pytest.mark.parametrize("p", [1, 4, 7])
def test_float64_pencil_matches_twin(cuda, p):
    """B.1's pencil apply in float64 (the kernel's double instance)
    against its twin within 1e-12, on every pencil of (2, 2)."""
    sp = FESpace(HyperCubeMesh(3, 3), p)
    n, sx, sy = 8, 2, 2
    K1, M1 = assembled_1d_matrices(sp)
    gK, gM = diagonal_1d_factors(sp)
    m1 = sp.free_mask_1d()
    Kx, Mx = _partial_assembled_1d(sp, n // sx)
    Ky, My = _partial_assembled_1d(sp, n // sy)
    facs = [_pencil_factors(v, n, p, sx, sy, 3) for v in (m1, gK, gM)]
    rng = np.random.default_rng(p)
    for s in range(sx * sy):
        (mx, my, _), (kx, ky, _), (mmx, mmy, _) = (f[s] for f in facs)
        op = cuda_laplace_pencil_from_factors(
            p, n, (n // sx, n // sy), m1, K1, M1, gK, gM,
            (mx, Kx, Mx, kx, mmx), (my, Ky, My, ky, mmy), torch.float64,
            cuda)
        u = torch.as_tensor(rng.standard_normal(op.input_shape), device=cuda)
        (got,), (want,) = op.run("apply", u), op.twin("apply", u)
        assert float((got - want).abs().max()) <= 1e-12 * float(
            want.abs().max())


@pytest.mark.parametrize("mesh,r", [((2, 2), 3), ((4, 2), 4)])
def test_pencil_solve_on_one_card(cuda, mesh, r):
    """sx x sy pencils on one card, float32, kernel path: the
    single-device count at float32 state, x within 1e-5 max|x|, the pencil
    modes launched."""
    st, launches, _ = chip_smoke.sharded_solve(
        "card", [cuda] * (mesh[0] * mesh[1]), 2, r, f"Q2 r={r} {mesh}",
        mesh=mesh)
    assert st.converged
    assert launches["laplace"]["apply/pencil"] > 0
    assert launches["cheb2"]["cheb2/pencil/mxu"] > 0


def test_float64_plain_pencil_matches_single_device(cuda):
    x, st = Sharded2DGeometricPoisson(3, 2, 3, (2, 2),
                                      devices=[cuda] * 4).solve()
    x1, st1 = GeometricMultigridPoisson(3, 2, 3, torch.float64, "auto",
                                        device=cuda).solve()
    assert st.iterations == st1.iterations
    assert st.solution_l2_norm == pytest.approx(st1.solution_l2_norm,
                                                rel=1e-10)
