"""B.4 at bfloat16 state against the JAX package, on the CPU.

The 2D recurrence runs on the exact operator with r and d stored in
bfloat16, as in the JAX package (``ops/pallas_laplace2d.py:30-32``): each
mode against ``PallasLaplace2D._run(..., sdtype="bf16")`` in interpret
mode (``zpad=0``), and the fused smoother's apply, smooth and residual
against JAX's ``FusedChebyshev(state_dtype="bf16")``, as
tests/test_pallas2d.py:62-92 holds it against the plain smoother.  Inputs
are made with numpy from a seed.  Outputs carry the JAX dtypes and stay
within 8e-3 max|out| of JAX's (the JAX package's own bound is 3e-2); the
residual path is exact in both, to 2e-6.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.ops.pallas_laplace2d import make_pallas_laplace2d
from portable_multigrid_tpu.solvers.chebyshev import (
    FusedChebyshev as JFused,
)
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_laplace2d import make_cuda_laplace2d
from portable_multigrid_tpu_torch.solvers.chebyshev import FusedChebyshev

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _pmg_defaults():
    """Every PMG_* setting of both packages at its default."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("PMG_")]:
            mp.delenv(key)
        yield


BOUND = 8e-3
SCAL = (0.59, 1.26)
# (p, r, bx): bx*p a multiple of 8, two x blocks or more where it fits
CASES = [(2, 3, 4), (3, 3, 8), (4, 3, 2)]
INS = {"cheb": ("r", "x"), "chebl": ("r", "x"), "chebd": ("r",),
       "chebdl": ("r",)}


def masked(N, rng):
    v = rng.standard_normal((N, N)).astype(np.float32)
    v[0], v[:, 0] = 0.0, 0.0
    return v


def as_bf16(v):
    j = jnp.asarray(v, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def close(got, want, bound=BOUND):
    assert str(got.dtype).split(".")[-1] == str(jnp.asarray(want).dtype)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    got = got.double().numpy()
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= bound * np.abs(want).max(), (err, np.abs(want).max())


def operators(p, r, bx):
    jop = make_pallas_laplace2d(JSpace(JMesh(2, r), p), jnp.float32, bx=bx,
                                interpret=True, zpad=0)
    top = make_cuda_laplace2d(FESpace(HyperCubeMesh(2, r), p), torch.float32)
    return jop, top


@pytest.mark.parametrize("p,r,bx", CASES)
def test_bf16_modes_match_jax(p, r, bx):
    jop, top = operators(p, r, bx)
    N = (2 ** r) * p
    rng = np.random.default_rng(p)
    (jd, td), (jr, tr) = as_bf16(masked(N, rng)), as_bf16(masked(N, rng))
    x, u, rhs = masked(N, rng), masked(N, rng), masked(N, rng)
    want = jop._run("residual3t", jnp.asarray(u), (jnp.asarray(rhs),),
                    np.asarray([1.3, 1.3], np.float32), sdtype="bf16")
    got = top.run("residual3t", torch.from_numpy(u), (torch.from_numpy(rhs),),
                  (1.3,), sdtype=torch.bfloat16)
    for g, w in zip(got, want):
        close(g, w)
    jins = {"r": jr, "x": jnp.asarray(x)}
    tins = {"r": tr, "x": torch.from_numpy(x)}
    for mode, keys in INS.items():
        want = jop._run(mode, jd, tuple(jins[k] for k in keys),
                        np.asarray(SCAL, np.float32), sdtype="bf16")
        want = want if isinstance(want, tuple) else (want,)
        got = top.run(mode, td, tuple(tins[k] for k in keys), SCAL,
                      sdtype=torch.bfloat16)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w)


def test_bf16_fused_smoother_matches_jax():
    p, r, bx = 2, 3, 4
    jop, top = operators(p, r, bx)
    jsm = JFused(degree=5, op=jop, op_smooth=jop, trimmed_io=True,
                 state_dtype="bf16", theta=jnp.asarray(1.3, jnp.float32),
                 delta=jnp.asarray(0.9, jnp.float32))
    tsm = FusedChebyshev(degree=5, op=top, theta=1.3, delta=0.9,
                         op_smooth=top, state_dtype=torch.bfloat16)
    N = (2 ** r) * p
    rng = np.random.default_rng(1)
    b, u = masked(N, rng), masked(N, rng)
    jb, ju = jnp.asarray(b), jnp.asarray(u)
    tb, tu = torch.from_numpy(b), torch.from_numpy(u)
    close(tsm.apply(tb), jsm.apply(jb))
    close(tsm.smooth(tu, tb), jsm.smooth(ju, jb))
    # the residual path is exact whatever the state dtype
    close(tsm.residual(tu, tb), jsm.residual(ju, jb), 2e-6)
