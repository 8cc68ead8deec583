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
