"""The full-grid fused smoother and B.1's untrimmed ``residual`` mode.

* ``FusedChebyshev(trimmed_io=False)`` ``apply``, ``smooth`` and
  ``residual`` against the JAX package's ``FusedChebyshev(trimmed_io=
  False)`` on an interpret-mode ``make_pallas_laplace(..., core="banded")``
  (run as ``tests/test_pallas_zpad.py`` runs it), in float32 to 5e-6 of
  max; in float64 to 1e-12 of max, ``residual`` against the same smoother
  and all three against the JAX package's plain ``Chebyshev`` algebra on
  its ``kron`` operator (``u + cheb(b - A u)``, as
  ``tests/test_pallas_smoother.py`` states it): the JAX smoother hands its
  recurrence coefficients to the kernel in float32 (the port's in the
  working dtype), which moves a float64 apply by ~1e-9 of max.  theta and
  delta are float32 numbers, so that the residual's theta is the same on
  both sides.  And against the port's own trimmed smoother, as
  ``tests/test_pallas_smoother.py::test_trimmed_io_matches_full`` holds
  the JAX package's two representations;
* the mode's twin against the JAX kernel's ``_run("residual")`` and
  against ``residual3t`` of the trimmed fields;
* the V-cycle that ``bench.py`` builds with ``PMG_BENCH_TRIMMED=0``
  (``models.poisson.build_untrimmed_vcycle``) at Q4 r=2 in float32: the
  same CG count as the model's trimmed V-cycle with single steps, and its
  launches of the untrimmed mode counted nowhere on the CPU.

``make_pallas_laplace`` needs by * p % 8 == 0 with by dividing the cells
per axis, so p = 2 runs at r = 2 (by = 4) and p = 3 at r = 3 (by = 8);
p = 4 at r = 1.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.ops.laplace import make_laplace as jlaplace
from portable_multigrid_tpu.ops.pallas_laplace import make_pallas_laplace
from portable_multigrid_tpu.solvers.chebyshev import Chebyshev as JCheb
from portable_multigrid_tpu.solvers.chebyshev import (
    FusedChebyshev as JFused,
)
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.models.poisson import (
    GeometricMultigridPoisson,
    build_untrimmed_vcycle,
)
from portable_multigrid_tpu_torch.ops import cuda_laplace
from portable_multigrid_tpu_torch.ops.cuda_laplace import make_cuda_laplace
from portable_multigrid_tpu_torch.ops.transfer import trim_last_planes
from portable_multigrid_tpu_torch.solvers.cg import cg
from portable_multigrid_tpu_torch.solvers.chebyshev import (
    FusedChebyshev,
    make_chebyshev,
)

torch.set_num_threads(1)

THETA, DELTA = float(np.float32(1.3)), float(np.float32(0.9))
BAR = {torch.float32: 5e-6, torch.float64: 1e-12}
JDT = {torch.float32: jnp.float32, torch.float64: jnp.float64}
# (p, r, by): the JAX kernel's block, by * p % 8 == 0
CASES = [(2, 2, 4), (3, 3, 8), (4, 1, 2)]


def _fields(sp, dtype, seed):
    """Masked u and b on the full grid (NumPy, float64) from a seed."""
    rng = np.random.default_rng(seed)
    m = sp.free_mask()
    return tuple(rng.standard_normal(sp.grid_shape) * m for _ in range(2))


def _close(got, want, bar):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= bar, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("p,r,by", CASES)
def test_full_grid_smoother_matches_jax(p, r, by, dtype):
    jsp = JSpace(JMesh(3, r), p)
    jdt = JDT[dtype]
    jop = make_pallas_laplace(jsp, jdt, bx=by, by=by, interpret=True,
                              core="banded")
    theta, delta = jnp.asarray(THETA, jdt), jnp.asarray(DELTA, jdt)
    jsm = JFused(degree=5, op=jop, op_smooth=jop, theta=theta, delta=delta,
                 trimmed_io=False)
    sp = FESpace(HyperCubeMesh(3, r), p)
    op = make_cuda_laplace(sp, dtype)
    sm = FusedChebyshev(degree=5, op=op, theta=THETA, delta=DELTA,
                        trimmed_io=False)
    u, b = _fields(sp, dtype, p + r)
    ju, jb = (jnp.asarray(a, JDT[dtype]) for a in (u, b))
    tu, tb = (torch.as_tensor(a, dtype=dtype) for a in (u, b))
    bar = BAR[dtype]
    got = (sm.apply(tb), sm.smooth(tu, tb), sm.residual(tu, tb))
    want = (jsm.apply(jb), jsm.smooth(ju, jb), jsm.residual(ju, jb))
    if dtype == torch.float64:
        kron = jlaplace(jsp, jdt, variant="kron")
        plain = JCheb(degree=5, op=kron, inv_diag=None, theta=theta,
                      delta=delta)
        res = jb - kron.apply(ju)
        _close(got[2], want[2], bar)
        want = (plain.apply(jb), ju + plain.apply(res), res * kron.mask)
    for g, w in zip(got, want):
        _close(g, w, bar)
    # the mode itself against the JAX kernel's: r0 and d0, trimmed
    jr0, jd0 = jop._run("residual", ju, (jb,),
                        jnp.asarray([THETA, THETA], jnp.float32))
    r0, d0 = op.run("residual", tu, (tb,), (THETA,))
    _close(r0, jr0, bar)
    _close(d0, jd0, bar)


@pytest.mark.parametrize("p,r", [(2, 2), (4, 2)])
def test_full_grid_matches_trimmed(p, r):
    """The two representations compute the same smoother: full-grid
    results trimmed against the trimmed smoother's on the trimmed inputs
    (float64, 1e-12 of max), and the untrimmed mode's r0 and d0 equal to
    residual3t's (the same operator, the same epilogue)."""
    sp = FESpace(HyperCubeMesh(3, r), p)
    op = make_cuda_laplace(sp, torch.float64)
    full = FusedChebyshev(degree=5, op=op, theta=THETA, delta=DELTA,
                          trimmed_io=False)
    trim = FusedChebyshev(degree=5, op=op, theta=THETA, delta=DELTA)
    u, b = (torch.as_tensor(a) for a in _fields(sp, torch.float64, 7))
    tt = lambda t: trim_last_planes(t, 3).contiguous()
    for got, want in ((full.apply(b), trim.apply(tt(b))),
                      (full.smooth(u, b), trim.smooth(tt(u), tt(b))),
                      (full.residual(u, b), trim.residual(tt(u), tt(b)))):
        assert tuple(got.shape) == sp.grid_shape
        assert float(tt(got).sub(want).abs().max()) <= (
            1e-12 * float(want.abs().max()))
        # the last planes are Dirichlet: the smoother leaves u there
    r0, d0 = op.run("residual", u, (b,), (THETA,))
    r3, d3, _ = op.run("residual3t", tt(u), (tt(b),), (THETA,))
    assert torch.equal(r0, r3) and torch.equal(d0, d3)


def test_residual_mode_checks_its_inputs():
    """The untrimmed mode takes full-grid inputs and B.1 alone has it: a
    trimmed u, or the 2D operator, is refused."""
    sp = FESpace(HyperCubeMesh(3, 1), 2)
    op = make_cuda_laplace(sp, torch.float64)
    full = torch.zeros(sp.grid_shape, dtype=torch.float64)
    trimmed = torch.zeros(op.trimmed_shape, dtype=torch.float64)
    with pytest.raises(ValueError, match="shape"):
        op.run("residual", trimmed, (full,), (THETA,))
    with pytest.raises(ValueError, match="takes 1 inputs"):
        op.run("residual", full, (), (THETA,))
    assert cuda_laplace.KERNEL_MODES.index("residual") == 7
    assert "residual" not in cuda_laplace.MODES


def test_make_chebyshev_takes_trimmed_io():
    """make_chebyshev's trimmed_io reaches the fused smoother; the port's
    default stays trimmed."""
    op = make_cuda_laplace(FESpace(HyperCubeMesh(3, 1), 2), torch.float64)
    assert make_chebyshev(op, fused=True).trimmed_io
    assert not make_chebyshev(op, fused=True, trimmed_io=False).trimmed_io


def test_untrimmed_vcycle_cg_count(monkeypatch):
    """bench.py's PMG_BENCH_TRIMMED=0 hierarchy at Q4 r=2 in float32 (bf16
    grade, plain transfers, no trimmed level) under CG to rtol 1e-5: the
    same count as the model's trimmed V-cycle with B.1 single steps
    (PMG_CHEB2=0) and as the default with B.2 pairs, L2 within 1e-6."""
    monkeypatch.setenv("PMG_CHEB2R", "0")
    counts = {}
    for cheb2 in ("0", "1"):
        monkeypatch.setenv("PMG_CHEB2", cheb2)
        prob = GeometricMultigridPoisson(3, 4, 2, torch.float32, "auto",
                                         "cpu")
        _, st = prob.solve(rtol=1e-5)
        counts[cheb2] = st.iterations
    mg = build_untrimmed_vcycle(prob.spaces, torch.float32, "cpu")
    assert not mg.fine_trimmed
    assert all(not getattr(lvl.smoother, "trimmed_io", False)
               for lvl in mg.levels)
    assert all(isinstance(lvl.smoother, FusedChebyshev)
               for lvl in mg.levels[1:])
    res = cg(mg.levels[-1].op.apply, prob.rhs(), mg.apply, rtol=1e-5)
    assert res.converged
    assert res.iterations == counts["0"] == counts["1"]
    l2 = prob.solution_l2_norm(res.x.double().numpy())
    assert abs(l2 - st.solution_l2_norm) <= 1e-6 * st.solution_l2_norm


def test_kernel_arguments_match_the_entry_point():
    """The arguments the wrapper hands to pmg_laplace_f32/_f64 (u, two
    inputs, three outputs, the operator's arrays, c0, c1, its sizes, the
    degree, the mode, the tile, the flags, the stream) are as many as the
    entry point's signature for the cube, the slab and the pencil; the
    cube's sizes take the full grid's input extents N + 1 in the untrimmed
    mode alone."""
    from portable_multigrid_tpu_torch import _build
    from portable_multigrid_tpu_torch.parallel.mesh2d import (
        _build_pencil_kernel,
    )
    from portable_multigrid_tpu_torch.parallel.poisson import (
        _build_stacked_slab,
    )

    sp = FESpace(HyperCubeMesh(3, 2), 2)
    cpu = torch.device("cpu")
    cube = make_cuda_laplace(sp, torch.float32)
    slab = _build_stacked_slab(sp, [cpu] * 2, torch.float32).local[0]
    pencil = _build_pencil_kernel(sp, (2, 2), [cpu] * 4,
                                  torch.float32).local[0]
    for op in (cube, slab, pencil):
        n = (6 + len(op.kernel_state()) + len(op.kernel_scalars()) + 2
             + len(op.kernel_sizes()) + 2 + len(op.tile) + 2)
        assert n == len(_build._SIGNATURES["pmg_laplace"])
    assert cube.kernel_sizes() == (8,) * 6
    assert cube.kernel_sizes(True) == (8, 8, 9, 8, 9, 9)
    assert slab.kernel_sizes() == (8, 8, 8, 4, 5, 8)
    assert pencil.kernel_sizes() == (8, 4, 5, 4, 5, 8)
