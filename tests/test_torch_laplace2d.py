"""Port parity: the B.4 2D operator (``ops/cuda_laplace2d.py``) against the
JAX package, on CPU, where the wrapper runs its plain twin.

* every mode of the twin against ``PallasLaplace2D._run`` in interpret mode
  (``zpad=0``, at least two x blocks), in float32, to 5e-6 relative — the
  bound of the 3D twin's test (tests/test_torch_laplace.py); p = 1 and 2
  here, p = 4 and 7 in tests/test_torch_laplace2d_high.py (each interpret
  run takes 1-2 s, so the degrees are split over two files);
* ``CudaLaplace2D.apply`` against ``dense_operator`` and the JAX ``kron``
  apply in float64, to 1e-12;
* the 2D ``FusedChebyshev`` (apply, smooth, residual) against the plain
  ``Chebyshev`` in float64, to 1e-12;
* the stiffness row sums of the difference form, and a float32 ladder
  that keeps the float64 L2 norm, which the direct banded sum does not;
* the untrimmed ``residual`` mode, which the TPU kernel never had, raises;
* each 2D level's fused smoother runs on the level's own operator.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem.assemble import dense_operator
from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.ops.laplace import make_laplace as jmake_laplace
from portable_multigrid_tpu.ops.pallas_laplace2d import make_pallas_laplace2d
from portable_multigrid_tpu_torch import PolynomialMultigridPoisson
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_laplace import SMEM_LIMIT
from portable_multigrid_tpu_torch.ops.cuda_laplace2d import (
    CudaLaplace2D,
    LAUNCHES,
    laplace2d_blocks,
    laplace2d_smem_elems,
    laplace2d_tile,
    make_cuda_laplace2d,
)
from portable_multigrid_tpu_torch.solvers.chebyshev import (
    Chebyshev,
    FusedChebyshev,
)

torch.set_num_threads(1)

MODES = ["apply", "residual1t", "residual3t", "cheb", "chebl", "chebd",
         "chebdl"]
THETA = np.float32(1.3)
C0, C1 = np.float32(0.59), np.float32(1.26)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(a).max()


def _spaces(p, r):
    return JSpace(JMesh(2, r), p), FESpace(HyperCubeMesh(2, r), p)


def _masked(sp, rng, dtype=np.float32):
    return (rng.standard_normal(sp.grid_shape) * sp.free_mask()).astype(dtype)


def check_twin_matches_pallas_run(p, r, bx, mode):
    """The B.4 twin against the TPU kernel in interpret mode, one mode; the
    TPU kernel needs bx*p % 8 == 0 and n % bx == 0."""
    jsp, sp = _spaces(p, r)
    jop = make_pallas_laplace2d(jsp, jnp.float32, bx=bx, interpret=True,
                                zpad=0)
    op = make_cuda_laplace2d(sp, torch.float32)
    rng = np.random.default_rng(7)
    full = [_masked(sp, rng) for _ in range(3)]
    u, r_, x = (f[:-1, :-1].copy() for f in full)
    if mode == "apply":
        # the TPU kernel takes the full grid here, the port trimmed state
        want = (jop._run("apply", jnp.asarray(full[0])),)
        got = op.run("apply", torch.as_tensor(u))
    else:
        if mode == "residual1t":
            jins, jscal, scal = (r_,), None, ()
        elif mode == "residual3t":
            jins, jscal, scal = (r_,), [THETA, THETA], (float(THETA),)
        elif mode in ("chebd", "chebdl"):
            jins, jscal, scal = (r_,), [C0, C1], (float(C0), float(C1))
        else:
            jins, jscal, scal = (r_, x), [C0, C1], (float(C0), float(C1))
        want = jop._run(mode, jnp.asarray(u),
                        tuple(jnp.asarray(a) for a in jins),
                        None if jscal is None else jnp.asarray(jscal))
        got = op.run(mode, torch.as_tensor(u),
                     tuple(torch.as_tensor(a) for a in jins), scal)
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        assert _rel(w, g.numpy()) <= 5e-6


# (p, r, bx) with at least two x blocks (p = 1 needs bx = 8, so r = 4)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,r,bx", [(1, 4, 8), (2, 3, 4)])
def test_twin_matches_pallas_run(p, r, bx, mode):
    check_twin_matches_pallas_run(p, r, bx, mode)


@pytest.mark.parametrize("p,r", [(1, 3), (3, 2), (7, 1)])
def test_apply_matches_dense_and_kron(p, r):
    jsp, sp = _spaces(p, r)
    u = np.random.default_rng(p).standard_normal(sp.grid_shape)
    want = np.asarray(jmake_laplace(jsp, jnp.float64, "kron").apply(
        jnp.asarray(u)))
    dense = (dense_operator(jsp) @ u.reshape(-1)).reshape(sp.grid_shape)
    assert _rel(dense, want) < 1e-12
    got = make_cuda_laplace2d(sp, torch.float64).apply(
        torch.as_tensor(u)).numpy()
    assert _rel(want, got) < 1e-12
    assert _rel(dense, got) < 1e-12


def test_inverse_diagonal_matches_jax():
    jsp, sp = _spaces(4, 2)
    want = np.asarray(jmake_laplace(jsp, jnp.float64, "kron").inv_diag)
    np.testing.assert_allclose(make_cuda_laplace2d(sp, torch.float64)
                               .inv_diag.numpy(), want, rtol=1e-14)


@pytest.mark.parametrize("p,r", [(2, 3), (5, 2)])
def test_fused_chebyshev_matches_plain(p, r):
    sp = FESpace(HyperCubeMesh(2, r), p)
    op = make_cuda_laplace2d(sp, torch.float64)
    plain = Chebyshev(degree=5, op=op, theta=1.3, delta=0.9)
    fused = FusedChebyshev(degree=5, op=op, theta=1.3, delta=0.9)
    rng = np.random.default_rng(1)
    b, u = (torch.as_tensor(_masked(sp, rng, np.float64)) for _ in range(2))
    trim = lambda t: t[:-1, :-1].contiguous()
    pad = lambda t: torch.nn.functional.pad(t, (0, 1, 0, 1))
    assert _rel(plain.apply(b), pad(fused.apply(trim(b)))) < 1e-12
    assert _rel(u + plain.apply(b - op.apply(u)),
                pad(fused.smooth(trim(u), trim(b)))) < 1e-12
    assert _rel(b - op.apply(u), pad(fused.residual(trim(u), trim(b)))) < 1e-12


@pytest.mark.parametrize("p,r", [(1, 3), (7, 3)])
def test_row_sums_are_those_of_the_folded_stiffness(p, r):
    op = make_cuda_laplace2d(FESpace(HyperCubeMesh(2, r), p), torch.float64)
    N = op.trimmed_shape[0]
    Kt = torch.zeros(N, N, dtype=torch.float64)
    for o in range(-p, p + 1):
        i = torch.arange(max(0, -o), min(N, N - o))
        Kt[i, i + o] = op.kband[p + o, i]
    scale = float(op.kband.abs().max())
    assert float((Kt.sum(1) - op.ksum).abs().max()) <= 1e-13 * scale
    assert float(op.ksum[p + 1:N - p].abs().max()) == 0.0


def test_float32_ladder_keeps_the_mesh_converged_norm():
    """The difference form keeps the float32 solve at the float64 L2 norm;
    the direct banded sum (the TPU kernel's) is 1.3e-4 off at this size."""
    _, s64 = PolynomialMultigridPoisson(2, 7, 5, 7, torch.float64,
                                        device="cpu").solve()
    _, s32 = PolynomialMultigridPoisson(2, 7, 5, 7, torch.float32,
                                        device="cpu").solve(rtol=1e-5)
    assert s32.converged and s32.iterations <= 3
    assert s32.solution_l2_norm == pytest.approx(s64.solution_l2_norm,
                                                 rel=1e-6)


def test_untrimmed_residual_mode_raises():
    op = make_cuda_laplace2d(FESpace(HyperCubeMesh(2, 1), 2), torch.float64)
    u = torch.zeros(op.trimmed_shape, dtype=torch.float64)
    with pytest.raises(ValueError, match="'residual'"):
        op.run("residual", u, (u,), (1.0,))


def test_wrapper_checks_layout_on_every_device():
    """A view of a full grid is refused on the CPU as the kernel refuses it
    on the card, so a layout fault of the ladder shows in the CPU tests."""
    op = make_cuda_laplace2d(FESpace(HyperCubeMesh(2, 1), 2), torch.float64)
    full = torch.zeros(op.grid_shape, dtype=torch.float64)
    with pytest.raises(ValueError, match="contiguous"):
        op.run("apply", full[:-1, :-1])
    with pytest.raises(ValueError, match="dtype"):
        op.run("apply", full[:-1, :-1].contiguous().float())


def test_cpu_tensors_run_the_twin_and_count_nothing():
    op = make_cuda_laplace2d(FESpace(HyperCubeMesh(2, 2), 3), torch.float32)
    before = dict(LAUNCHES)
    op.apply(torch.ones(op.grid_shape))
    assert LAUNCHES == before
    assert op.trimmed_shape == (12, 12) and op.grid_shape == (13, 13)


@pytest.mark.parametrize("p", [1, 4, 7])
def test_tile_fits_shared_memory(p):
    """The operator carries the kernel's (LX, TY, NW) for its own grid:
    one y point a thread, the blocks an SM holds within shared memory."""
    for itemsize, dtype in ((4, torch.float32), (8, torch.float64)):
        op = make_cuda_laplace2d(FESpace(HyperCubeMesh(2, 3), p), dtype)
        N = op.trimmed_shape[0]
        lx, ty, nw = op.tile
        assert op.tile == laplace2d_tile(p, itemsize, N)
        assert ty == 32 * nw and 1 <= lx <= N
        assert (laplace2d_blocks(itemsize) * laplace2d_smem_elems(p, ty)
                * itemsize <= SMEM_LIMIT)


def test_levels_share_one_operator():
    prob = PolynomialMultigridPoisson(2, 3, 1, dtype=torch.float64, device="cpu")
    assert all(isinstance(lvl.op, CudaLaplace2D) for lvl in prob.levels)
    for lvl in prob.levels[1:]:
        assert isinstance(lvl.smoother, FusedChebyshev)
        assert lvl.smoother.op is lvl.op and lvl.smoother.op_cheb2 is None
    coarse = prob.levels[0].smoother
    assert isinstance(coarse, FusedChebyshev) and coarse.op_cheb2 is None
    assert coarse.op is prob.levels[0].op
