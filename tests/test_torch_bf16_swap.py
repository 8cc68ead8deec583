"""The JAX package's own bf16 swap against the port's default, on the CPU.

The JAX package pins its production grade by swapping the fine smoother of
``MixedPrecisionPoisson(3, 4, 2, mg_dtype=float32)`` for a
``FusedChebyshev`` with the exact operator, the ``"mxu"`` recurrence
operator, the production pair kernel and bfloat16 state
(tests/test_pallas_smoother.py:214-248, tests/test_pallas_cheb2.py:109-140).
That solve runs in interpret mode in a child process, started when this
module starts (~40 s).  Meanwhile the port's fused smoother at the same
grade is held against JAX's on one level, and the port's default solve,
which builds that grade on every fused level, must take the swapped
solve's CG count exactly, with the L2 norm to 1e-7.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.ops.laplace import (
    assembled_1d_matrices as jassembled_1d_matrices,
)
from portable_multigrid_tpu.ops.pallas_cheb2 import make_cheb2 as jmake_cheb2
from portable_multigrid_tpu.ops.pallas_laplace import make_pallas_laplace
from portable_multigrid_tpu.solvers.chebyshev import (
    FusedChebyshev as JFused,
)
from portable_multigrid_tpu_torch import MixedPrecisionPoisson, convert
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_cheb2 import make_cheb2
from portable_multigrid_tpu_torch.ops.cuda_laplace import make_cuda_laplace
from portable_multigrid_tpu_torch.solvers.chebyshev import FusedChebyshev

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _pmg_defaults():
    """Every PMG_* setting of both packages at its default."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("PMG_")]:
            mp.delenv(key)
        yield


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CHILD = """
import json
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
from portable_multigrid_tpu.models.mixed import MixedPrecisionPoisson
from portable_multigrid_tpu.ops.pallas_cheb2 import make_cheb2
from portable_multigrid_tpu.ops.pallas_laplace import make_pallas_laplace
from portable_multigrid_tpu.solvers.chebyshev import FusedChebyshev
from portable_multigrid_tpu.solvers.vcycle import MGLevel, wire_trimmed
prob = MixedPrecisionPoisson(3, 4, 2, mg_dtype=jnp.float32)
sp = prob.spaces[-1]
exact = make_pallas_laplace(sp, jnp.float32, bx=4, by=4, interpret=True)
mxu = make_pallas_laplace(sp, jnp.float32, bx=4, by=4, interpret=True,
                          core="mxu")
k2 = make_cheb2(sp, jnp.float32, bx=4, by=4, interpret=True)
lv = list(prob.levels)
l = lv[-1]
sm = FusedChebyshev(degree=l.smoother.degree, op=exact, op_smooth=mxu,
                    op_cheb2=k2, theta=l.smoother.theta,
                    delta=l.smoother.delta, trimmed_io=True,
                    state_dtype="bf16")
lv[-1] = MGLevel(op=exact, smoother=sm, transfer=l.transfer)
wired, _ = wire_trimmed(lv)
prob.levels = tuple(wired)
prob.fine_trimmed = True
_, st = prob.solve()
print(json.dumps(dict(iterations=st.iterations, converged=st.converged,
                      solution_l2_norm=st.solution_l2_norm)))
"""


@pytest.fixture(scope="module", autouse=True)
def jax_swap(_pmg_defaults):
    # the child inherits the environment _pmg_defaults cleaned
    proc = subprocess.Popen([sys.executable, "-c", _CHILD], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def masked(N, rng):
    v = rng.standard_normal((N,) * 3).astype(np.float32)
    v[0], v[:, 0], v[:, :, 0] = 0.0, 0.0, 0.0
    return v


def test_production_smoother_matches_jax():
    """apply and smooth of the fused smoother at the production grade (exact
    residual3t, mxu single step, production pairs, bf16 state), degree 4
    so that a pair and a single step both run, within 8e-3 max|out|."""
    p, r = 2, 2
    jsp, sp = JSpace(JMesh(3, r), p), FESpace(HyperCubeMesh(3, r), p)
    kw = dict(bx=4, by=4, interpret=True, zpad=0)
    jexact = make_pallas_laplace(jsp, jnp.float32, **kw)
    jmxu = make_pallas_laplace(jsp, jnp.float32, core="mxu", **kw)
    jsm = JFused(degree=4, op=jexact, op_smooth=jmxu,
                 op_cheb2=jmake_cheb2(jsp, jnp.float32, **kw),
                 theta=jnp.asarray(1.3, jnp.float32),
                 delta=jnp.asarray(0.9, jnp.float32), trimmed_io=True,
                 state_dtype="bf16")
    exact = make_cuda_laplace(sp, torch.float32)
    mxu = make_cuda_laplace(sp, torch.float32, core="mxu")
    tsm = FusedChebyshev(degree=4, op=exact, theta=1.3, delta=0.9,
                         op_cheb2=make_cheb2(mxu), op_smooth=mxu,
                         state_dtype=torch.bfloat16)
    # the same smoother mapped from the JAX one's state by convert
    K1, M1 = jassembled_1d_matrices(jsp)

    def from_jax(jop):
        return convert.kernel_operator(
            degree=p, n=jop.n[0], mask1=np.asarray(jop.mask1[0]),
            dK1=np.asarray(jop.dK1[0]), dM1=np.asarray(jop.dM1[0]), K1=K1,
            M1=M1, dtype=torch.float32, core=jop.core)

    cexact, cmxu = from_jax(jexact), from_jax(jmxu)
    assert cmxu.core == "mxu" and torch.equal(cmxu.kband, mxu.kband)
    conv = convert.smoother(cexact, degree=jsm.degree, theta=jsm.theta,
                            delta=jsm.delta, fused=True, op_smooth=cmxu,
                            state_dtype=jsm.state_dtype)
    assert conv.op_cheb2.op is cmxu and conv.state_dtype == torch.bfloat16
    N = (2 ** r) * p
    rng = np.random.default_rng(5)
    b, u = masked(N, rng), masked(N, rng)
    for got, want in ((tsm.apply(torch.from_numpy(b)),
                       jsm.apply(jnp.asarray(b))),
                      (tsm.smooth(torch.from_numpy(u), torch.from_numpy(b)),
                       jsm.smooth(jnp.asarray(u), jnp.asarray(b))),
                      (conv.smooth(torch.from_numpy(u), torch.from_numpy(b)),
                       jsm.smooth(jnp.asarray(u), jnp.asarray(b)))):
        assert got.dtype == torch.float32
        want = np.asarray(want, np.float64)
        err = np.abs(got.double().numpy() - want).max()
        assert err <= 8e-3 * np.abs(want).max()


def test_default_solve_takes_the_jax_swap_count(jax_swap):
    prob = MixedPrecisionPoisson(3, 4, 2, torch.float32, "auto", "cpu")
    _, st = prob.solve()
    out, err = jax_swap.communicate(timeout=600)
    assert jax_swap.returncode == 0, err
    want = json.loads(out.strip().splitlines()[-1])
    assert st.converged and want["converged"]
    assert st.iterations == want["iterations"]
    assert st.solution_l2_norm == pytest.approx(want["solution_l2_norm"],
                                                rel=1e-7)
