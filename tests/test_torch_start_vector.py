"""The Lanczos start vector above 2^25 grid points: the port draws it on
the operator's device, bit for bit as the JAX package's
``jax.random.uniform(jax.random.PRNGKey(42), shape, dtype, -0.5, 0.5)``
(``portable_multigrid_tpu/solvers/chebyshev.py:676-691``), and masks it
with the free-DoF grid mask.  Below the threshold both packages draw with
NumPy on the host (tests/test_torch_solvers.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.ops.laplace import make_laplace as jmake_laplace
from portable_multigrid_tpu.solvers import chebyshev as jcheb
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_elasticity import (
    make_cuda_elasticity,
)
from portable_multigrid_tpu_torch.ops.cuda_laplace import make_cuda_laplace
from portable_multigrid_tpu_torch.ops.laplace import make_laplace
from portable_multigrid_tpu_torch.solvers import chebyshev as tcheb

torch.set_num_threads(1)

DTYPES = [(torch.float32, jnp.float32), (torch.float64, jnp.float64)]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("dtype,jdtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 5, 7), (33,)])
def test_device_draw_matches_jax_bitwise(dtype, jdtype, shape, monkeypatch):
    """Odd sizes (JAX pads its count array to an even length in the
    non-partitionable scheme), drawn in chunks of 16 so that the flat
    index crosses chunk boundaries."""
    monkeypatch.setattr(tcheb, "_DRAW_CHUNK", 16)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(42), shape,
                                         jdtype, -0.5, 0.5))
    got = tcheb.jax_uniform(shape, dtype, "cpu")
    assert got.dtype == dtype and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_threshold_picks_the_device_draw(monkeypatch):
    """Above DEVICE_DRAW_POINTS (lowered here, not the size raised)
    make_chebyshev never builds the host draw, and its bounds are those of
    the JAX package's Lanczos run from the masked jax.random start vector."""
    monkeypatch.setattr(tcheb, "DEVICE_DRAW_POINTS", 100)

    def no_host_draw(shape):
        raise AssertionError("host draw above the threshold")

    monkeypatch.setattr(tcheb, "_pseudo_random_grid", no_host_draw)
    p, r = 2, 2
    jsp, sp = JSpace(JMesh(3, r), p), FESpace(HyperCubeMesh(3, r), p)
    assert sp.n_dofs > 100
    sm = tcheb.make_chebyshev(make_cuda_laplace(sp, torch.float64))
    jop = jmake_laplace(jsp, jnp.float64, "kron")
    v0 = (jax.random.uniform(jax.random.PRNGKey(42), jsp.grid_shape,
                             jnp.float64, -0.5, 0.5)
          * jnp.asarray(jsp.free_mask()))
    lo, hi = jcheb.estimate_eigenvalues(jop, None, 10, v0)
    alpha, beta, degree = jcheb.chebyshev_bounds(lo, hi, 15.0, 5)
    assert sm.degree == degree
    np.testing.assert_allclose([sm.theta, sm.delta],
                               [(beta + alpha) / 2, (beta - alpha) / 2],
                               rtol=1e-10)


def test_threshold_keeps_the_host_draw_below(monkeypatch):
    calls = []
    host = tcheb._pseudo_random_grid
    monkeypatch.setattr(tcheb, "_pseudo_random_grid",
                        lambda shape: calls.append(shape) or host(shape))
    op = make_cuda_laplace(FESpace(HyperCubeMesh(3, 1), 2), torch.float64)
    tcheb.make_chebyshev(op)
    assert calls == [op.shape]


@pytest.mark.parametrize("which", ["kernel3d", "kron2d", "elasticity"])
def test_device_mask_is_the_host_mask(which):
    sp = FESpace(HyperCubeMesh(2 if which == "kron2d" else 3, 1), 2)
    op = {"kernel3d": lambda: make_cuda_laplace(sp, torch.float64),
          "kron2d": lambda: make_laplace(sp, torch.float64, "kron"),
          "elasticity": lambda: make_cuda_elasticity(sp, torch.float64)}[which]()
    m = tcheb._device_free_mask(op)
    assert m.dtype == op.dtype
    np.testing.assert_array_equal(m.numpy(), tcheb._host_free_mask(op))
    np.testing.assert_array_equal(m.numpy(), sp.free_mask())
