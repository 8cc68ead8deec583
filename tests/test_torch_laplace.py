"""Port parity: the Laplace operators against the JAX package.

* the kron operator and the B.1 operator's full-grid apply (its plain twin
  on CPU) against JAX ``make_laplace(..., "kron")`` and ``dense_operator``
  to 1e-12 in float64;
* every ported mode of the B.1 twin against ``PallasLaplaceOperator._run``
  in interpret mode, in float32, to 5e-6 relative — the bound of the JAX
  package's own fused-smoother tests (tests/test_pallas_smoother.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem.assemble import dense_operator
from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.ops.laplace import make_laplace as jmake_laplace
from portable_multigrid_tpu.ops.pallas_laplace import make_pallas_laplace
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_laplace import make_cuda_laplace
from portable_multigrid_tpu_torch.ops.laplace import make_laplace

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(a).max()


@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_kron_and_kernel_apply_match_jax_and_dense(p):
    jsp, sp = JSpace(JMesh(3, 1), p), FESpace(HyperCubeMesh(3, 1), p)
    u = np.random.default_rng(p).standard_normal(sp.grid_shape)
    want = np.asarray(jmake_laplace(jsp, jnp.float64, "kron").apply(
        jnp.asarray(u)))
    dense = (dense_operator(jsp) @ u.reshape(-1)).reshape(sp.grid_shape)
    assert _rel(dense, want) < 1e-12
    ut = torch.as_tensor(u)
    for op in (make_laplace(sp, torch.float64, "kron"),
               make_cuda_laplace(sp, torch.float64)):
        got = op.apply(ut).numpy()
        assert _rel(want, got) < 1e-12
        assert _rel(dense, got) < 1e-12


def test_inverse_diagonal_matches_jax():
    jsp, sp = JSpace(JMesh(3, 2), 3), FESpace(HyperCubeMesh(3, 2), 3)
    want = np.asarray(jmake_laplace(jsp, jnp.float64, "kron").inv_diag)
    for op in (make_laplace(sp, torch.float64, "kron"),
               make_cuda_laplace(sp, torch.float64)):
        np.testing.assert_allclose(op.inv_diag.numpy(), want, rtol=1e-14)


def test_unported_variant_names_its_roadmap_item():
    """bkron, the one variant the port leaves out, names its ROADMAP item
    (the ported sumfac is held to the JAX package in test_torch_sumfac.py)."""
    sp = FESpace(HyperCubeMesh(3, 1), 2)
    with pytest.raises(ValueError, match="ROADMAP queue B.*TPU-only"):
        make_laplace(sp, torch.float64, "bkron")


# (p, r, bx = by): Q4 r=2 with 2x2 blocks, Q2 r=3 with 4x4 blocks
# (the Pallas kernel needs by*p % 8 == 0)
CONFIGS = [(4, 2, 2), (2, 3, 4)]
MODES = ["apply", "residual1t", "residual3t", "cheb", "chebl", "chebd",
         "chebdl"]
THETA = np.float32(1.3)
C0, C1 = np.float32(0.59), np.float32(1.26)


def _masked(sp, rng):
    m = sp.free_mask()
    return (rng.standard_normal(sp.grid_shape) * m).astype(np.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,r,b", CONFIGS)
def test_kernel_twin_matches_pallas_run(p, r, b, mode):
    jsp, sp = JSpace(JMesh(3, r), p), FESpace(HyperCubeMesh(3, r), p)
    jop = make_pallas_laplace(jsp, jnp.float32, bx=b, by=b, interpret=True,
                              zpad=0)
    op = make_cuda_laplace(sp, torch.float32)
    rng = np.random.default_rng(7)
    full = [_masked(sp, rng) for _ in range(3)]
    u, r_, x = (f[:-1, :-1, :-1].copy() for f in full)
    if mode == "apply":
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
