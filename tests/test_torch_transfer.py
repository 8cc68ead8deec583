"""Port parity: grid transfers against the JAX package.

* ``Transfer`` / ``TrimmedTransfer`` against JAX ``make_h_transfer`` to
  1e-13 in float64;
* the B.3 twin against ``PallasTransfer`` in interpret mode (``bf=4``,
  Q4 r3 <-> r2) to 2e-5 in float32, the JAX package's own bound
  (tests/test_pallas_transfer.py), for both coarse representations;
* restriction is the exact transpose: <P c, f> = <c, R f>.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.ops.pallas_transfer import make_pallas_h_transfer
from portable_multigrid_tpu.ops.transfer import (
    TrimmedTransfer as JTrimmedTransfer,
    make_h_transfer as jmake_h_transfer,
)
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_transfer import make_cuda_h_transfer
from portable_multigrid_tpu_torch.ops.transfer import (
    TrimmedTransfer,
    make_h_transfer,
)

torch.set_num_threads(1)


def _pair(p, r, jax_side=False):
    if jax_side:
        return JSpace(JMesh(3, r - 1), p), JSpace(JMesh(3, r), p)
    return FESpace(HyperCubeMesh(3, r - 1), p), FESpace(HyperCubeMesh(3, r), p)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(a).max()


def _trim(a):
    return a[tuple(slice(0, s - 1) for s in a.shape)]


@pytest.mark.parametrize("p,r", [(1, 2), (2, 2), (3, 1), (4, 2)])
def test_transfer_matches_jax(p, r):
    jt = jmake_h_transfer(*_pair(p, r, True), jnp.float64)
    tt = make_h_transfer(*_pair(p, r), torch.float64)
    coarse, fine = _pair(p, r)
    rng = np.random.default_rng(p)
    f = rng.standard_normal(fine.grid_shape)
    c = rng.standard_normal(coarse.grid_shape)
    u = rng.standard_normal(fine.grid_shape)
    assert _rel(jt.restrict(jnp.asarray(f)), tt.restrict(torch.as_tensor(f))) < 1e-13
    assert _rel(jt.prolongate(jnp.asarray(c)),
                tt.prolongate(torch.as_tensor(c))) < 1e-13
    assert _rel(jt.prolongate_and_add(jnp.asarray(u), jnp.asarray(c)),
                tt.prolongate_and_add(torch.as_tensor(u),
                                      torch.as_tensor(c))) < 1e-13


@pytest.mark.parametrize("coarse_trimmed", [True, False])
def test_trimmed_transfer_matches_jax(coarse_trimmed):
    p, r = 3, 2
    coarse, fine = _pair(p, r)
    jt = JTrimmedTransfer(fine_trimmed=True, coarse_trimmed=coarse_trimmed,
                          base=jmake_h_transfer(*_pair(p, r, True), jnp.float64))
    tt = TrimmedTransfer(fine_trimmed=True, coarse_trimmed=coarse_trimmed,
                         base=make_h_transfer(coarse, fine, torch.float64))
    rng = np.random.default_rng(5)
    f = _trim(rng.standard_normal(fine.grid_shape) * fine.free_mask())
    c = rng.standard_normal(coarse.grid_shape) * coarse.free_mask()
    c = _trim(c) if coarse_trimmed else c
    assert _rel(jt.restrict(jnp.asarray(f)), tt.restrict(torch.as_tensor(f))) < 1e-13
    assert _rel(jt.prolongate(jnp.asarray(c)),
                tt.prolongate(torch.as_tensor(c))) < 1e-13


@pytest.mark.parametrize("coarse_trimmed", [True, False])
def test_kernel_twin_matches_pallas_transfer(coarse_trimmed):
    p, r = 4, 3
    jt = make_pallas_h_transfer(*_pair(p, r, True), jnp.float32, bf=4,
                                coarse_trimmed=coarse_trimmed, interpret=True)
    tt = make_cuda_h_transfer(*_pair(p, r), torch.float32,
                              coarse_trimmed=coarse_trimmed)
    coarse, fine = _pair(p, r)
    rng = np.random.default_rng(1)
    f = _trim(rng.standard_normal(fine.grid_shape)).astype(np.float32)
    u = _trim(rng.standard_normal(fine.grid_shape)).astype(np.float32)
    c = rng.standard_normal(coarse.grid_shape).astype(np.float32)
    c = _trim(c) if coarse_trimmed else c
    pairs = [
        (jt.restrict(jnp.asarray(f)), tt.restrict(torch.as_tensor(f))),
        (jt.prolongate(jnp.asarray(c)), tt.prolongate(torch.as_tensor(c))),
        (jt.prolongate_and_add(jnp.asarray(u), jnp.asarray(c)),
         tt.prolongate_and_add(torch.as_tensor(u), torch.as_tensor(c))),
    ]
    for want, got in pairs:
        assert tuple(got.shape) == want.shape
        assert _rel(want, got.numpy()) <= 2e-5


@pytest.mark.parametrize("p", [1, 2, 4, 7])
def test_restriction_is_exact_transpose(p):
    coarse, fine = _pair(p, 2)
    rng = np.random.default_rng(p)
    f = torch.as_tensor(rng.standard_normal(fine.grid_shape))
    c = torch.as_tensor(rng.standard_normal(coarse.grid_shape))
    plain = make_h_transfer(coarse, fine, torch.float64)
    lhs = torch.sum(plain.prolongate(c) * f)
    rhs = torch.sum(c * plain.restrict(f))
    assert abs(float(lhs - rhs)) <= 1e-12 * abs(float(lhs))
    kern = make_cuda_h_transfer(coarse, fine, torch.float64)
    ft, ct = f[:-1, :-1, :-1].contiguous(), c[:-1, :-1, :-1].contiguous()
    lhs = torch.sum(kern.prolongate(ct) * ft)
    rhs = torch.sum(ct * kern.restrict(ft))
    assert abs(float(lhs - rhs)) <= 1e-12 * abs(float(lhs))
