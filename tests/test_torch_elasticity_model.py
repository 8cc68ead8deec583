"""The elasticity slice as a whole: the port's ``ElasticityMultigrid``
against the JAX package's kron model, on CPU (the kernel wrappers run their
twins), in float64 to rtol 1e-12 — CG counts exact, L2 norms to 1e-10.

This file holds Q2 r=2 in 3D, one V-cycle of kernel levels rebuilt from the
JAX level state with ``convert``, and the row of ``chip_smoke.py``'s pinned
table that the JAX solve gives; Q3 and 2D are in
tests/test_torch_elasticity_q3.py and the Q3 r=3 row in
tests/test_torch_elasticity_blocks.py.  A JAX solve compiles for 15-25 s,
so each runs in a child process (:class:`JaxSolve`), started when its
module starts, while the module's other tests run.
"""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from portable_multigrid_tpu.models.elasticity import (
    ElasticityMultigrid as JElasticity,
)
from portable_multigrid_tpu.ops.laplace import diagonal_1d_factors
from portable_multigrid_tpu.solvers.vcycle import VCycle as JVCycle
from portable_multigrid_tpu_torch import ElasticityMultigrid, convert
from portable_multigrid_tpu_torch.ops.cuda_elasticity import (
    CudaElasticityOperator,
)
from portable_multigrid_tpu_torch.ops.cuda_transfer import CudaTransfer
from portable_multigrid_tpu_torch.solvers.chebyshev import (
    Chebyshev,
    FusedChebyshev,
)
from portable_multigrid_tpu_torch.solvers.vcycle import MGLevel, VCycle, wire_trimmed

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CHILD = """
import json
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
from portable_multigrid_tpu.models.elasticity import ElasticityMultigrid
dim, p, r = map(int, sys.argv[1:4])
x, st = ElasticityMultigrid(dim, p, r, dtype=jnp.float64,
                            variant="kron").solve()
np.save(sys.argv[4], np.asarray(x))
print(json.dumps(dict(iterations=st.iterations, converged=st.converged,
                      solution_l2_norm=st.solution_l2_norm,
                      n_dofs=st.n_dofs, dofs_per_level=st.dofs_per_level)))
"""


class JaxSolve:
    """The JAX package's float64 kron elasticity solve of (dim, p, r),
    running in a child process from construction on."""

    def __init__(self, dim, p, r, tmp_dir):
        self.x_path = os.path.join(str(tmp_dir), f"jax_x_{dim}{p}{r}.npy")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(dim), str(p), str(r),
             self.x_path], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self._result = None

    def result(self):
        """(solve stats, solution) once the child has finished."""
        if self._result is None:
            out, err = self.proc.communicate(timeout=300)
            assert self.proc.returncode == 0, err
            stats = types.SimpleNamespace(
                **json.loads(out.strip().splitlines()[-1]))
            self._result = stats, np.load(self.x_path)
        return self._result

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()


def jax_solve_fixture(dim, p, r):
    """A module fixture that starts the JAX solve of (dim, p, r) when the
    module starts."""
    @pytest.fixture(scope="module", autouse=True)
    def fixture(tmp_path_factory):
        solve = JaxSolve(dim, p, r, tmp_path_factory.mktemp("jax"))
        yield solve
        solve.close()
    return fixture


def same_solve(st, jst):
    """The port's solve stats equal the JAX package's."""
    assert st.converged and jst.converged
    assert st.iterations == jst.iterations
    assert st.n_dofs == jst.n_dofs and st.dofs_per_level == jst.dofs_per_level
    assert st.solution_l2_norm == pytest.approx(jst.solution_l2_norm, rel=1e-10)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(a).max()


jax_q2 = jax_solve_fixture(3, 2, 2)


def test_auto_levels_run_the_kernels():
    prob = ElasticityMultigrid(3, 2, 2, dtype=torch.float64, variant="auto",
                               device="cpu")
    assert prob.fine_trimmed
    assert all(isinstance(lvl.op, CudaElasticityOperator) for lvl in prob.levels)
    for lvl in prob.levels[1:]:
        assert isinstance(lvl.smoother, FusedChebyshev)
        assert lvl.smoother.op is lvl.op and lvl.smoother.op_cheb2 is None
        assert isinstance(lvl.transfer, CudaTransfer)
    assert isinstance(prob.levels[0].smoother, Chebyshev)
    assert prob.levels[0].smoother.op is prob.levels[0].op


def test_vcycle_from_jax_state_matches():
    """Kernel levels (B.5 twins, fused smoothers on trimmed state, B.3 on
    each component) rebuilt from the JAX kron model's level state give
    the JAX V-cycle."""
    jprob = JElasticity(3, 2, 2, dtype=jnp.float64, variant="kron")
    levels = []
    for i, (jl, jsp) in enumerate(zip(jprob.levels, jprob.spaces)):
        jop = jl.op
        dK1, dM1 = diagonal_1d_factors(jsp)
        op = convert.elasticity_operator(
            degree=jop.degree, n=jop.n[0], dim=3,
            mask1=np.asarray(jop.mask)[:, 1, 1], dK1=dK1, dM1=dM1,
            K1=np.asarray(jop.Kg), M1=np.asarray(jop.Mg),
            G1=np.asarray(jop.Gg), mu=jop.mu, lam=jop.lam, kernel=True)
        sm = convert.smoother(op, degree=jl.smoother.degree,
                              theta=jl.smoother.theta, delta=jl.smoother.delta,
                              fused=i > 0)
        tr = None
        if i > 0:
            jt = jl.transfer
            tr = convert.kernel_transfer(
                n_coarse=jt.n_coarse[0], stride_c=jt.stride_c,
                stride_f=jt.stride_f, M1=np.asarray(jt.M1),
                wmask_f=np.asarray(jt.wmask_f[0]),
                mask_c1=np.asarray(jt.mask_c1[0]), coarse_trimmed=i > 1)
        levels.append(MGLevel(op=op, smoother=sm, transfer=tr))
    levels, fine_trimmed = wire_trimmed(levels)
    assert fine_trimmed
    mg = VCycle(levels=tuple(levels), fine_trimmed=True)
    sp = jprob.spaces[-1]
    b = (np.random.default_rng(4).standard_normal((3,) + sp.grid_shape)
         * sp.free_mask()[None])
    # jitted, as the JAX model runs it (eager dispatch takes 2.5x longer)
    want = jax.jit(lambda m, v: m.apply(v))(JVCycle(levels=jprob.levels),
                                            jnp.asarray(b))
    assert _rel(want, mg.apply(torch.as_tensor(b))) < 1e-12


@pytest.mark.parametrize("variant", ["kron", "auto"])
def test_q2_matches_jax(jax_q2, variant):
    jst, jx = jax_q2.result()
    prob = ElasticityMultigrid(3, 2, 2, dtype=torch.float64, variant=variant,
                               device="cpu")
    x, st = prob.solve()
    same_solve(st, jst)
    assert np.abs(jx - x.numpy()).max() <= 1e-9 * np.abs(jx).max()


def test_pinned_row_matches_jax(jax_q2):
    jst, _ = jax_q2.result()
    iterations, l2 = chip_smoke.ELASTICITY_F64[(2, 2)]
    assert iterations == jst.iterations
    assert l2 == pytest.approx(jst.solution_l2_norm, rel=1e-12)
