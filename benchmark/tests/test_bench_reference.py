"""The plain reference operator (``configs/laplace.py``) against a dense
assembled one, and its lower-precision form that the control uses."""

import numpy as np
import pytest
import torch

from conftest import BENCH
from pmgbench.spec import load_module
from portable_multigrid_tpu_torch.fem.assemble import dense_operator
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace

laplace = load_module(BENCH / "configs" / "laplace.py", "laplace_reference")


@pytest.mark.parametrize("dim,degree,r", [(2, 2, 2), (2, 7, 1), (3, 2, 2),
                                          (3, 4, 1)])
def test_reference_equals_dense_operator(dim, degree, r):
    space = FESpace(HyperCubeMesh(dim, r), degree)
    A = dense_operator(space)
    ref = laplace.make({"dim": dim, "degree": degree, "refinements": r},
                       "cpu")
    x = np.random.default_rng(3).standard_normal(space.grid_shape)
    got = ref.apply(torch.as_tensor(x)).numpy().reshape(-1)
    want = A @ x.reshape(-1)
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


def test_lower_precision_reference_is_coarser():
    cfg = {"dim": 3, "degree": 4, "refinements": 1}
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((9,) * 3))
    exact = laplace.make(cfg, "cpu").apply(x)
    for dtype, lo, hi in ((torch.float32, 1e-8, 1e-5),
                          (torch.bfloat16, 1e-4, 1e-1)):
        got = laplace.make(cfg, "cpu", dtype).apply(x)
        assert got.dtype == x.dtype
        err = float((got - exact).abs().max() / exact.abs().max())
        assert lo < err < hi, (dtype, err)


@pytest.mark.parametrize("rows", [1, 3, None])
@pytest.mark.parametrize("dim,degree,r", [(2, 3, 3), (2, 7, 2), (3, 2, 3),
                                          (3, 4, 2)])
def test_blocked_reference_equals_the_whole_grid_one(dim, degree, r, rows):
    """``make_blocked``'s solve and apply against ``make``'s, in blocks of
    one plane, of three planes and of the whole grid (the default)."""
    cfg = {"dim": dim, "degree": degree, "refinements": r}
    n = (1 << r) * degree + 1
    whole = laplace.make(cfg, "cpu")
    blocked = (laplace.make_blocked(cfg, "cpu") if rows is None else
               laplace.make_blocked(cfg, "cpu",
                                    block_bytes=rows * 8 * n ** (dim - 1)))
    assert len(blocked.blocks()) == -(-n // (rows or n))
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((n,) * dim))
    for got, want in ((blocked.apply(x), whole.apply(x)),
                      (blocked.solve(x), whole.solve(x))):
        assert got.shape == want.shape and got.dtype == torch.float64
        assert float((got - want).abs().max()) <= 1e-13 * float(
            want.abs().max())
    g = x.clone()
    assert blocked.solve_(g) is g
    assert torch.equal(g, blocked.solve(x))


def test_blocked_lower_precision_is_the_whole_grids():
    cfg = {"dim": 3, "degree": 4, "refinements": 1}
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((9,) * 3))
    for dtype in (torch.float32, torch.bfloat16):
        got = laplace.make_blocked(cfg, "cpu", dtype, block_bytes=1).apply(x)
        want = laplace.make(cfg, "cpu", dtype).apply(x)
        assert got.dtype == x.dtype
        err = float((got - want).abs().max() / want.abs().max())
        assert err < {torch.float32: 1e-6, torch.bfloat16: 2e-2}[dtype]
