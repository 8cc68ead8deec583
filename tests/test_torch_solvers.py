"""Port parity: CG, Chebyshev smoothers and the V-cycle against the JAX
package, on state carried across with ``portable_multigrid_tpu_torch.convert``
(same operators, same transfers, same Chebyshev bounds)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.models.poisson import (
    GeometricMultigridPoisson as JPoisson,
)
from portable_multigrid_tpu.ops.laplace import make_laplace as jmake_laplace
from portable_multigrid_tpu.ops.pallas_cheb2 import make_cheb2 as jmake_cheb2
from portable_multigrid_tpu.ops.pallas_laplace import make_pallas_laplace
from portable_multigrid_tpu.solvers import chebyshev as jcheb
from portable_multigrid_tpu.solvers.cg import cg as jcg
from portable_multigrid_tpu.solvers.vcycle import VCycle as JVCycle
from portable_multigrid_tpu_torch import convert
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_cheb2 import make_cheb2
from portable_multigrid_tpu_torch.ops.cuda_laplace import make_cuda_laplace
from portable_multigrid_tpu_torch.solvers import chebyshev as tcheb
from portable_multigrid_tpu_torch.solvers.cg import cg
from portable_multigrid_tpu_torch.solvers.vcycle import MGLevel, VCycle, wire_trimmed

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(a).max()


def _op_state(jop):
    """The JAX kron operator's 1D state as NumPy arrays."""
    return dict(degree=jop.degree, n=jop.n[0],
                mask1=np.asarray(jop.mask1[0]), dK1=np.asarray(jop.dK1[0]),
                dM1=np.asarray(jop.dM1[0]), K1=np.asarray(jop.Kg[0]),
                M1=np.asarray(jop.Mg[0]))


def _ports(jop):
    """Both port operators (plain kron and B.1) built from the JAX state."""
    st = _op_state(jop)
    return (convert.laplace_operator(dim=3, **st),
            convert.kernel_operator(**st))


@pytest.mark.parametrize("args", [
    (0.1, 2.0, 15.0, 5), (0.01, 3.7, 1e-3, None), (1e-9, 1.5, 1e-3, None),
    (0.5, 0.7, 15.0, 3), (2.0, 2.0, 1e-3, None)])
def test_chebyshev_bounds_equal(args):
    assert tcheb.chebyshev_bounds(*args) == jcheb.chebyshev_bounds(*args)


@pytest.mark.parametrize("p,r,n_iter", [(2, 2, 10), (3, 1, 64), (1, 2, 27)])
def test_estimate_eigenvalues_match(p, r, n_iter):
    jsp = JSpace(JMesh(3, r), p)
    jop = jmake_laplace(jsp, jnp.float64, "kron")
    v0 = (jcheb._pseudo_random_grid(jsp.grid_shape, np.float64)
          * jsp.free_mask())
    want = jcheb.estimate_eigenvalues(jop, None, n_iter, jnp.asarray(v0))
    for op in _ports(jop):
        got = tcheb.estimate_eigenvalues(op, n_iter, torch.as_tensor(v0))
        np.testing.assert_allclose(got, want, rtol=1e-10)


def test_cg_matches():
    jsp = JSpace(JMesh(3, 2), 2)
    jop = jmake_laplace(jsp, jnp.float64, "kron")
    b = np.random.default_rng(0).standard_normal(jsp.grid_shape) * jsp.free_mask()
    jidg = jop.inv_diag
    want = jcg(jop.apply, jnp.asarray(b), lambda v: jidg * v, rtol=1e-10)
    for op in _ports(jop):
        idg = op.inv_diag
        got = cg(op.apply, torch.as_tensor(b), lambda v: idg * v, rtol=1e-10)
        assert got.iterations == int(want.iterations)
        assert got.converged and bool(want.converged)
        assert _rel(want.x, got.x) < 1e-10


def test_chebyshev_apply_matches():
    jsp = JSpace(JMesh(3, 2), 3)
    jop = jmake_laplace(jsp, jnp.float64, "kron")
    jsm = jcheb.make_chebyshev(jop)
    b = np.random.default_rng(1).standard_normal(jsp.grid_shape) * jsp.free_mask()
    want = jsm.apply(jnp.asarray(b))
    for op in _ports(jop):
        sm = convert.smoother(op, degree=jsm.degree, theta=jsm.theta,
                              delta=jsm.delta)
        assert _rel(want, sm.apply(torch.as_tensor(b))) < 1e-12


def test_make_chebyshev_bounds_match():
    """The port's setup estimates the same bounds from the same start vector."""
    jsp = JSpace(JMesh(3, 2), 2)
    sp = FESpace(HyperCubeMesh(3, 2), 2)
    jop = jmake_laplace(jsp, jnp.float64, "kron")
    for jkw, kw in [({}, {}),
                    (dict(smoothing_range=1e-3, degree=None,
                          eig_cg_n_iterations=jsp.n_dofs),
                     dict(smoothing_range=1e-3, degree=None,
                          eig_cg_n_iterations=sp.n_dofs))]:
        jsm = jcheb.make_chebyshev(jop, **jkw)
        sm = tcheb.make_chebyshev(make_cuda_laplace(sp, torch.float64), **kw)
        assert sm.degree == jsm.degree
        np.testing.assert_allclose([sm.theta, sm.delta],
                                   [float(jsm.theta), float(jsm.delta)],
                                   rtol=1e-10)


def test_eig_cap_comes_from_the_environment(monkeypatch):
    """PMG_EIG_MAX_ITERS caps the Lanczos length of the coarse-solver setup
    in both packages (729 DoFs, eig iterations = m()): at a cap of 7 the
    port estimates the JAX package's bounds, and not those of the default
    cap of 256."""
    jsp = JSpace(JMesh(3, 2), 2)
    sp = FESpace(HyperCubeMesh(3, 2), 2)
    op = make_cuda_laplace(sp, torch.float64)
    kw = dict(smoothing_range=1e-3, degree=None,
              eig_cg_n_iterations=sp.n_dofs)
    monkeypatch.delenv("PMG_EIG_MAX_ITERS", raising=False)
    full = tcheb.make_chebyshev(op, **kw)
    monkeypatch.setenv("PMG_EIG_MAX_ITERS", "7")
    jsm = jcheb.make_chebyshev(jmake_laplace(jsp, jnp.float64, "kron"), **kw)
    sm = tcheb.make_chebyshev(op, **kw)
    assert sm.degree == jsm.degree
    np.testing.assert_allclose([sm.theta, sm.delta],
                               [float(jsm.theta), float(jsm.delta)],
                               rtol=1e-10)
    assert abs(sm.delta / full.delta - 1) > 1e-3


@pytest.mark.parametrize("pair", [True, False])
def test_fused_chebyshev_matches(pair):
    """FusedChebyshev (trimmed) against the JAX package's, whose kernels run
    in Pallas interpret mode, in float32 (bound of
    tests/test_pallas_cheb2.py)."""
    p, r, blk = 4, 2, 2
    jsp, sp = JSpace(JMesh(3, r), p), FESpace(HyperCubeMesh(3, r), p)
    jop = make_pallas_laplace(jsp, jnp.float32, bx=blk, by=blk, interpret=True,
                              zpad=0)
    jk2 = (jmake_cheb2(jsp, jnp.float32, bx=blk, by=blk, zpad=0,
                       interpret=True, exact=True) if pair else None)
    theta, delta = jnp.asarray(1.3, jnp.float32), jnp.asarray(0.9, jnp.float32)
    degree = 5 if pair else 4
    jf = jcheb.FusedChebyshev(degree=degree, op=jop, op_smooth=jop,
                              theta=theta, delta=delta, trimmed_io=True,
                              op_cheb2=jk2)
    op = make_cuda_laplace(sp, torch.float32)
    tf = tcheb.FusedChebyshev(degree=degree, op=op, theta=float(theta),
                              delta=float(delta),
                              op_cheb2=make_cheb2(op) if pair else None)
    rng = np.random.default_rng(2)
    m = sp.free_mask()[:-1, :-1, :-1]
    bt, ut = ((rng.standard_normal(m.shape) * m).astype(np.float32)
              for _ in range(2))
    jb, ju = jnp.asarray(bt), jnp.asarray(ut)
    tb, tu = torch.as_tensor(bt), torch.as_tensor(ut)
    assert _rel(jf.apply(jb), tf.apply(tb)) <= 2e-5
    assert _rel(jf.smooth(ju, jb), tf.smooth(tu, tb)) <= 2e-5
    assert _rel(jf.residual(ju, jb), tf.residual(tu, tb)) <= 2e-5


def _port_levels(jlevels, kernels: bool):
    """Port levels from the JAX kron problem's level state."""
    levels = []
    for i, jl in enumerate(jlevels):
        st = _op_state(jl.op)
        op = (convert.kernel_operator(**st) if kernels
              else convert.laplace_operator(dim=3, **st))
        sm = convert.smoother(op, degree=jl.smoother.degree,
                              theta=jl.smoother.theta, delta=jl.smoother.delta,
                              fused=kernels and i > 0)
        tr = None
        if i > 0:
            jt = jl.transfer
            tst = dict(n_coarse=jt.n_coarse[0], stride_c=jt.stride_c,
                       stride_f=jt.stride_f, M1=np.asarray(jt.M1),
                       wmask_f=np.asarray(jt.wmask_f[0]),
                       mask_c1=np.asarray(jt.mask_c1[0]))
            tr = (convert.kernel_transfer(coarse_trimmed=i > 1, **tst)
                  if kernels else convert.plain_transfer(dim=3, **tst))
        levels.append(MGLevel(op=op, smoother=sm, transfer=tr))
    return wire_trimmed(levels)


@pytest.mark.parametrize("kernels", [True, False])
def test_vcycle_apply_matches(kernels):
    jprob = JPoisson(3, 2, 2, jnp.float64, "kron")
    jmg = JVCycle(levels=jprob.levels)
    levels, fine_trimmed = _port_levels(jprob.levels, kernels)
    assert fine_trimmed == kernels
    mg = VCycle(levels=tuple(levels), fine_trimmed=fine_trimmed)
    sp = jprob.spaces[-1]
    b = np.random.default_rng(4).standard_normal(sp.grid_shape) * sp.free_mask()
    assert _rel(jmg.apply(jnp.asarray(b)), mg.apply(torch.as_tensor(b))) < 1e-10
