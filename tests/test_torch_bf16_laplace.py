"""B.1's bf16 grade against the JAX package, on the CPU: the ``"mxu"``
smoother operator at bfloat16 state (modes cheb, chebl, chebd, chebdl)
and the exact operator's ``residual3t`` with bfloat16 outputs.

The JAX side runs ``PallasLaplaceOperator._run`` in interpret mode, as its
own tests do (``make_pallas_laplace(..., bx=4, by=4 or 8, interpret=True,
zpad=0)``; by*p must be a multiple of 8, so p = 3 runs at r = 3 with
by = 8), on the same inputs, made with numpy from a seed; the port runs its
twin (``CudaLaplaceOperator.run`` on CPU tensors).  Outputs carry the JAX
dtypes, and each stays within 8e-3 max|out| of JAX's: two bf16 roundings
at the largest value, tighter than the JAX package's own bf16 bound of
3e-2 (tests/test_pallas2d.py:74).  The TPU core rounds its block boundary
rows in two halves and the port's bands the whole entry, so a rounding may
fall on the other side; on these inputs the bf16 outputs agree exactly.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.ops.pallas_laplace import make_pallas_laplace
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_laplace import (
    make_cuda_laplace,
    state_dtype,
)
from portable_multigrid_tpu_torch.ops.cuda_elasticity import (
    make_cuda_elasticity,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _pmg_defaults():
    """Every PMG_* setting of both packages at its default."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("PMG_")]:
            mp.delenv(key)
        yield


BF16_BOUND = 8e-3
RES3_BOUND = 8e-3
# (p, r, by): by*p a multiple of 8
CASES = [(2, 2, 4), (3, 3, 8), (4, 2, 4)]
SCAL = (0.59, 1.26)
INS = {"cheb": ("r", "x"), "chebl": ("r", "x"), "chebd": ("r",),
       "chebdl": ("r",)}


def masked(N, rng):
    """A float32 trimmed field, zero on the constrained first planes."""
    v = rng.standard_normal((N,) * 3).astype(np.float32)
    v[0], v[:, 0], v[:, :, 0] = 0.0, 0.0, 0.0
    return v


def as_bf16(v):
    """v rounded to bfloat16 by JAX, and the same values as a torch tensor."""
    j = jnp.asarray(v, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def close(got, want, bound):
    """got (torch) against want (JAX) of the same dtype, within bound
    max|want|."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    got = got.double().numpy()
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= bound * np.abs(want).max(), (err, np.abs(want).max())


def operators(p, r, by, core):
    jop = make_pallas_laplace(JSpace(JMesh(3, r), p), jnp.float32, bx=4,
                              by=by, interpret=True, core=core, zpad=0)
    top = make_cuda_laplace(FESpace(HyperCubeMesh(3, r), p), torch.float32,
                            "cpu", core=core)
    return jop, top


@pytest.mark.parametrize("p,r,by", CASES)
@pytest.mark.parametrize("mode", ["cheb", "chebl", "chebd", "chebdl"])
def test_mxu_cheb_family_matches_jax(mode, p, r, by):
    jop, top = operators(p, r, by, "mxu")
    N = (2 ** r) * p
    rng = np.random.default_rng(p * 10 + r)
    (jd, td), (jr, tr) = as_bf16(masked(N, rng)), as_bf16(masked(N, rng))
    x = masked(N, rng)
    jins = {"r": jr, "x": jnp.asarray(x)}
    tins = {"r": tr, "x": torch.from_numpy(x)}
    want = jop._run(mode, jd, tuple(jins[k] for k in INS[mode]),
                    np.asarray(SCAL, np.float32), sdtype="bf16")
    got = top.run(mode, td, tuple(tins[k] for k in INS[mode]), SCAL,
                  sdtype=torch.bfloat16)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        close(g, w, BF16_BOUND)


@pytest.mark.parametrize("p,r,by", CASES)
def test_residual3t_bf16_outputs_match_jax(p, r, by):
    jop, top = operators(p, r, by, "banded")
    N = (2 ** r) * p
    rng = np.random.default_rng(p)
    u, rhs = masked(N, rng), masked(N, rng)
    want = jop._run("residual3t", jnp.asarray(u), (jnp.asarray(rhs),),
                    np.asarray([1.3, 1.3], np.float32), sdtype="bf16")
    got = top.run("residual3t", torch.from_numpy(u), (torch.from_numpy(rhs),),
                  (1.3,), sdtype=torch.bfloat16)
    assert [g.dtype for g in got] == [torch.bfloat16, torch.bfloat16,
                                      torch.float32]
    for g, w in zip(got, want):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        close(g, w, RES3_BOUND)


def test_mxu_bands_are_bf16_with_their_row_sums():
    exact = make_cuda_laplace(FESpace(HyperCubeMesh(3, 2), 3), torch.float32)
    mxu = make_cuda_laplace(FESpace(HyperCubeMesh(3, 2), 3), torch.float32,
                            core="mxu")
    assert mxu.core == "mxu" and exact.core == "banded"
    for b in (mxu.kband, mxu.mband):
        assert torch.equal(b, b.to(torch.bfloat16).float())
    assert torch.allclose(mxu.kband, exact.kband, rtol=2 ** -8, atol=0)
    assert torch.allclose(mxu.ksum, mxu.kband.double().sum(0).float(),
                          rtol=1e-6, atol=1e-6)
    assert torch.equal(mxu.dK1, exact.dK1) and torch.equal(mxu.dM1, exact.dM1)


def test_bf16_state_is_float32_only_and_never_cast():
    sp = FESpace(HyperCubeMesh(3, 1), 2)
    with pytest.raises(ValueError, match="mxu"):
        make_cuda_laplace(sp, torch.float64, core="mxu")
    op64 = make_cuda_laplace(sp, torch.float64)
    with pytest.raises(ValueError, match="bfloat16 state"):
        state_dtype(op64, torch.bfloat16)
    el = make_cuda_elasticity(sp, torch.float32)
    with pytest.raises(ValueError, match="bfloat16 state"):
        state_dtype(el, torch.bfloat16)
    op = make_cuda_laplace(sp, torch.float32)
    d = torch.zeros(op.trimmed_shape)
    # the cheb family reads d and r in the state dtype: no silent cast
    with pytest.raises(ValueError, match="dtype"):
        op.run("chebd", d, (d,), SCAL, sdtype=torch.bfloat16)
    outs = op.run("chebd", d.bfloat16(), (d.bfloat16(),), SCAL,
                  sdtype=torch.bfloat16)
    assert [o.dtype for o in outs] == [torch.bfloat16, torch.bfloat16,
                                       torch.float32]
