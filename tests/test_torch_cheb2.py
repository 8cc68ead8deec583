"""Port parity: the B.2 pair-kernel twin against the JAX package's
``Cheb2Kernel.steps2`` (interpret mode, ``exact=True``) for all six ported
modes, to 2e-5 relative — the bound of tests/test_pallas_cheb2.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.ops.pallas_cheb2 import make_cheb2 as jmake_cheb2
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_cheb2 import make_cheb2
from portable_multigrid_tpu_torch.ops.cuda_laplace import make_cuda_laplace

torch.set_num_threads(1)

MODES = ["cheb2", "cheb2l", "chebd2", "chebd2l", "cheb2f0", "cheb2f0l"]
# (p, cells per axis, block): production degree at the minimum halo fit,
# and interior windows plus both edges at p = 2
CONFIGS = [(4, 4, 2), (2, 8, 4)]
SCAL = np.asarray([0.59, 1.26, 0.71, 1.52, 1.3], np.float32)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p,n,b", CONFIGS)
def test_pair_twin_matches_pallas(p, n, b, mode):
    r = int(np.log2(n))
    jsp, sp = JSpace(JMesh(3, r), p), FESpace(HyperCubeMesh(3, r), p)
    jk = jmake_cheb2(jsp, jnp.float32, bx=b, by=b, zpad=0, interpret=True,
                     exact=True)
    kern = make_cheb2(make_cuda_laplace(sp, torch.float32))
    rng = np.random.default_rng(3)
    m = sp.free_mask()[:-1, :-1, :-1]
    d, r_, x = ((rng.standard_normal(m.shape) * m).astype(np.float32)
                for _ in range(3))
    from_rhs = mode.startswith("cheb2f0")
    r_in = None if from_rhs else r_
    x_in = x if mode in ("cheb2", "cheb2l") else None
    scal = SCAL if from_rhs else SCAL[:4]
    want = jk.steps2(jnp.asarray(d), None if r_in is None else jnp.asarray(r_in),
                     None if x_in is None else jnp.asarray(x_in),
                     jnp.asarray(scal), mode)
    t = lambda a: None if a is None else torch.as_tensor(a)
    got = kern.steps2(t(d), t(r_in), t(x_in), tuple(map(float, scal)), mode)
    assert len(got) == len(want) == (1 if mode.endswith("l") else 3)
    for w, g in zip(want, got):
        w = np.asarray(w, np.float64)
        assert g.shape == w.shape
        assert np.abs(w - g.numpy()).max() <= 2e-5 * np.abs(w).max()
