"""Port parity of the elasticity path's multigrid pieces on vector fields,
against the JAX package, on CPU (kernel wrappers run their twins):

* the plain ``Transfer`` on [3, ...] fields against the JAX one (which
  vmaps over the component axis), restriction as the exact transpose of
  prolongation, and pad / trim of trimmed state on the spatial axes only;
* the B.3 wrapper on [3, ...] fields (one pass per component) against the
  plain vector ``Transfer`` wired to trimmed levels;
* ``make_chebyshev`` on vector levels gives the JAX package's theta, delta
  and degree (the start vector is drawn over the whole [3, ...] shape);
* the fused smoother on B.5 against the JAX plain ``Chebyshev`` in apply,
  smooth and residual, at degree 1, 2 and 5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.ops.elasticity import make_elasticity as jmake_elasticity
from portable_multigrid_tpu.ops.transfer import make_h_transfer as jmake_h_transfer
from portable_multigrid_tpu.solvers.chebyshev import (
    Chebyshev as JChebyshev,
    make_chebyshev as jmake_chebyshev,
)
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_elasticity import make_cuda_elasticity
from portable_multigrid_tpu_torch.ops.cuda_transfer import (
    LAUNCHES,
    make_cuda_h_transfer,
)
from portable_multigrid_tpu_torch.ops.elasticity import make_elasticity
from portable_multigrid_tpu_torch.ops.transfer import (
    TrimmedTransfer,
    make_h_transfer,
    pad_last_planes,
    trim_last_planes,
)
from portable_multigrid_tpu_torch.solvers.chebyshev import (
    FusedChebyshev,
    make_chebyshev,
)

torch.set_num_threads(1)

MU, LAM = 0.7, 1.3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(a).max()


def _pair(dim, p, r):
    """(JAX coarse, JAX fine, port coarse, port fine) spaces."""
    return (JSpace(JMesh(dim, r - 1), p), JSpace(JMesh(dim, r), p),
            FESpace(HyperCubeMesh(dim, r - 1), p), FESpace(HyperCubeMesh(dim, r), p))


@pytest.mark.parametrize("dim,p,r", [(2, 3, 2), (3, 2, 2)])
def test_vector_transfer_matches_jax(dim, p, r):
    jc, jf, c, f = _pair(dim, p, r)
    jt = jmake_h_transfer(jc, jf, jnp.float64)
    tt = make_h_transfer(c, f, torch.float64)
    rng = np.random.default_rng(p)
    fv = rng.standard_normal((dim,) + f.grid_shape)
    cv = rng.standard_normal((dim,) + c.grid_shape)
    Pc = tt.prolongate(torch.as_tensor(cv))
    Rf = tt.restrict(torch.as_tensor(fv))
    assert Pc.shape == (dim,) + f.grid_shape
    assert Rf.shape == (dim,) + c.grid_shape
    assert _rel(jt.prolongate(jnp.asarray(cv)), Pc) < 1e-13
    assert _rel(jt.restrict(jnp.asarray(fv)), Rf) < 1e-13
    lhs = float((Pc * torch.as_tensor(fv)).sum())
    rhs = float((torch.as_tensor(cv) * Rf).sum())
    assert lhs == pytest.approx(rhs, rel=1e-13)


def test_pad_and_trim_leave_the_component_axis_alone():
    t = torch.arange(3 * 4 * 4 * 4, dtype=torch.float64).reshape(3, 4, 4, 4)
    padded = pad_last_planes(t, 3)
    assert padded.shape == (3, 5, 5, 5)
    assert torch.equal(padded[:, :4, :4, :4], t)
    assert float(padded[:, 4].abs().sum() + padded[:, :, 4].abs().sum()
                 + padded[..., 4].abs().sum()) == 0.0
    assert torch.equal(trim_last_planes(padded, 3), t)
    # scalar state: every axis is spatial
    assert pad_last_planes(t[0], 3).shape == (5, 5, 5)
    assert torch.equal(trim_last_planes(pad_last_planes(t[0], 3), 3), t[0])


@pytest.mark.parametrize("coarse_trimmed", [True, False])
def test_kernel_transfer_runs_each_component(coarse_trimmed):
    _, _, c, f = _pair(3, 2, 2)
    kt = make_cuda_h_transfer(c, f, torch.float64, coarse_trimmed=coarse_trimmed)
    plain = TrimmedTransfer(fine_trimmed=True, coarse_trimmed=coarse_trimmed,
                            base=make_h_transfer(c, f, torch.float64))
    rng = np.random.default_rng(3)
    nf, nc = f.grid_shape[0] - 1, c.grid_shape[0] - (1 if coarse_trimmed else 0)
    fv = torch.as_tensor(rng.standard_normal((3, nf, nf, nf)))
    cv = torch.as_tensor(rng.standard_normal((3, nc, nc, nc)))
    fv = trim_last_planes(pad_last_planes(fv, 3) * torch.as_tensor(
        f.free_mask()), 3).contiguous()
    if not coarse_trimmed:
        cv = cv * torch.as_tensor(c.free_mask())
    before = dict(LAUNCHES)
    assert _rel(plain.restrict(fv), kt.restrict(fv)) < 1e-13
    assert _rel(plain.prolongate_and_add(fv, cv),
                kt.prolongate_and_add(fv, cv)) < 1e-13
    assert LAUNCHES == before  # CPU tensors run the twin


def _fm(sp, shape):
    return np.broadcast_to(sp.free_mask()[None], shape)


@pytest.mark.parametrize("coarse", [False, True])
def test_vector_level_bounds_match_jax(coarse):
    """theta, delta and the degree of the smoothing and coarse-solver
    configurations, from the Lanczos estimate on the [3, ...] start vector
    of the JAX package; the kron and B.5 (twin) operators agree."""
    r = 0 if coarse else 2
    jsp, sp = JSpace(JMesh(3, r), 2), FESpace(HyperCubeMesh(3, r), 2)
    jop = jmake_elasticity(jsp, jnp.float64, mu=MU, lam=LAM, variant="kron")
    kw = (dict(smoothing_range=1e-3, degree=None,
               eig_cg_n_iterations=jop.n_dofs) if coarse else
          dict(smoothing_range=15.0, degree=5, eig_cg_n_iterations=10))
    js = jmake_chebyshev(jop, free_mask=_fm(jsp, jop.shape), **kw)
    for op in (make_elasticity(sp, torch.float64, MU, LAM),
               make_cuda_elasticity(sp, torch.float64, MU, LAM)):
        sm = make_chebyshev(op, **kw)
        assert sm.degree == js.degree
        assert sm.theta == pytest.approx(float(js.theta), rel=1e-12)
        assert sm.delta == pytest.approx(float(js.delta), rel=1e-12)


@pytest.mark.parametrize("degree", [1, 2, 5])
def test_fused_vector_smoother_matches_jax_plain(degree):
    jsp, sp = JSpace(JMesh(3, 2), 2), FESpace(HyperCubeMesh(3, 2), 2)
    jop = jmake_elasticity(jsp, jnp.float64, mu=MU, lam=LAM, variant="kron")
    theta, delta = 1.3, 0.9
    plain = JChebyshev(degree=degree, op=jop, inv_diag=None,
                       theta=jnp.asarray(theta), delta=jnp.asarray(delta))
    op = make_cuda_elasticity(sp, torch.float64, MU, LAM)
    fused = FusedChebyshev(degree=degree, op=op, theta=theta, delta=delta)
    rng = np.random.default_rng(degree)
    fm = _fm(sp, op.shape)
    b, u = (rng.standard_normal(op.shape) * fm for _ in range(2))
    jb, ju = jnp.asarray(b), jnp.asarray(u)
    trim = lambda a: trim_last_planes(torch.as_tensor(a), 3).contiguous()  # noqa: E731
    pad = lambda t: pad_last_planes(t, 3).numpy()  # noqa: E731
    assert _rel(plain.apply(jb), pad(fused.apply(trim(b)))) < 1e-12
    assert _rel(ju + plain.apply(jb - jop.apply(ju)),
                pad(fused.smooth(trim(u), trim(b)))) < 1e-12
    assert _rel((jb - jop.apply(ju)) * fm,
                pad(fused.residual(trim(u), trim(b)))) < 1e-12
