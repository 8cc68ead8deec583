"""B.2's production grade against the JAX package, on the CPU: the pair
kernel made from the ``"mxu"`` operator (bf16 coefficients, every
contraction's input rounded to bf16) at bfloat16 state, all six modes,
against JAX's ``make_cheb2(..., exact=False)`` run in interpret mode with
``sdtype="bf16"``, as its own tests run it (``zpad=0``).  Inputs are made
with numpy from a seed.  Outputs carry the JAX dtypes and stay within 8e-3
max|out| of JAX's (two bf16 roundings at the largest value; the JAX
package's own bf16 bound is 3e-2, tests/test_pallas2d.py:74).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.ops.pallas_cheb2 import make_cheb2 as jmake_cheb2
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_cheb2 import MODES, make_cheb2
from portable_multigrid_tpu_torch.ops.cuda_laplace import make_cuda_laplace

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _pmg_defaults():
    """Every PMG_* setting of both packages at its default."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("PMG_")]:
            mp.delenv(key)
        yield


BOUND = 8e-3
SCAL = np.asarray([0.59, 1.26, 0.71, 1.52, 1.3], np.float32)
# (p, r, block): 2 x 2 blocks of edge windows; the production degree with
# the minimum halo fit
CASES = [(2, 3, 4), (4, 2, 2)]
_JAX = {}


def jax_kernel(p, r, b):
    key = (p, r, b)
    if key not in _JAX:
        _JAX[key] = jmake_cheb2(JSpace(JMesh(3, r), p), jnp.float32, bx=b,
                                by=b, zpad=0, interpret=True)
    return _JAX[key]


def masked(N, rng):
    v = rng.standard_normal((N,) * 3).astype(np.float32)
    v[0], v[:, 0], v[:, :, 0] = 0.0, 0.0, 0.0
    return v


def as_bf16(v):
    j = jnp.asarray(v, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


@pytest.mark.parametrize("p,r,b", CASES)
@pytest.mark.parametrize("mode", MODES)
def test_production_pair_matches_jax(mode, p, r, b):
    jk = jax_kernel(p, r, b)
    kern = make_cheb2(make_cuda_laplace(FESpace(HyperCubeMesh(3, r), p),
                                        torch.float32, core="mxu"))
    N = (2 ** r) * p
    rng = np.random.default_rng(p + r)
    (jd, td), (jr, tr) = as_bf16(masked(N, rng)), as_bf16(masked(N, rng))
    x, bvec = masked(N, rng), masked(N, rng)
    if mode.startswith("cheb2f0"):
        # the rhs b comes in float32
        jargs = (jnp.asarray(bvec), None, None, SCAL)
        targs = (torch.from_numpy(bvec), None, None, tuple(SCAL))
    else:
        has_x = mode in ("cheb2", "cheb2l")
        jargs = (jd, jr, jnp.asarray(x) if has_x else None, SCAL[:4])
        targs = (td, tr, torch.from_numpy(x) if has_x else None,
                 tuple(SCAL[:4]))
    want = jk.steps2(*jargs, mode, sdtype="bf16")
    want = want if isinstance(want, tuple) else (want,)
    got = kern.steps2(*targs, mode, sdtype=torch.bfloat16)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        w = np.asarray(w.astype(jnp.float32), np.float64)
        g = g.double().numpy()
        assert np.isfinite(g).all()
        err = np.abs(g - w).max()
        assert err <= BOUND * np.abs(w).max(), (err, np.abs(w).max())


def test_pair_takes_its_grade_from_the_operator():
    sp = FESpace(HyperCubeMesh(3, 1), 2)
    exact = make_cheb2(make_cuda_laplace(sp, torch.float32))
    prod = make_cheb2(make_cuda_laplace(sp, torch.float32, core="mxu"))
    assert exact.op.core == "banded" and prod.op.core == "mxu"
    rng = np.random.default_rng(0)
    d, r, x = (torch.from_numpy(masked(2 * 2, rng)) for _ in range(3))
    a = exact.steps2(d, r, x, tuple(SCAL[:4]), "cheb2")
    b = prod.steps2(d, r, x, tuple(SCAL[:4]), "cheb2")
    # float32 state on both; the production grade differs at bf16 level
    assert all(t.dtype == torch.float32 for t in a + b)
    rel = float((a[2] - b[2]).abs().max() / a[2].abs().max())
    assert 0 < rel < 3e-2
    with pytest.raises(ValueError, match="dtype"):
        prod.steps2(d, r, x, tuple(SCAL[:4]), "cheb2", sdtype=torch.bfloat16)
