"""The second slice: the 2D p-multigrid ladder of the port against the JAX
package and the golden table, on CPU (the B.4 wrapper runs its twin).

* ``make_p_transfer`` against the JAX one in float64 to 1e-13, and
  restriction as the exact transpose of prolongation;
* ``PolynomialMultigridPoisson(..., "auto")`` on the ``polynomial_2d``
  golden rows, in float64: CG counts exact, L2 to 1e-10; further ladders,
  solved by the JAX package at test time, are in
  tests/test_torch_pmg_ladders.py and tests/test_torch_pmg_q7.py (a JAX
  solve compiles for 10-30 s, so they are spread over files);
* the 2D geometric path through the same operator, against the JAX
  package's solve;
* one V-cycle of a p-ladder rebuilt from the JAX level state with
  ``convert`` against the JAX V-cycle, in float64 to 1e-12;
* the driver prints the JAX driver's lines.
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
from portable_multigrid_tpu.models.poisson import (
    GeometricMultigridPoisson as JGeometric,
    PolynomialMultigridPoisson as JPolynomial,
)
from portable_multigrid_tpu.ops.transfer import make_p_transfer as jmake_p_transfer
from portable_multigrid_tpu.solvers.vcycle import VCycle as JVCycle
from portable_multigrid_tpu_torch import (
    GeometricMultigridPoisson,
    PolynomialMultigridPoisson,
    convert,
)
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_laplace2d import CudaLaplace2D
from portable_multigrid_tpu_torch.ops.transfer import TrimmedTransfer, make_p_transfer
from portable_multigrid_tpu_torch.solvers.vcycle import MGLevel, VCycle, wire_trimmed

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(a).max()


def _golden():
    with open(os.path.join(ROOT, "tests", "golden_convergence.json")) as fh:
        return json.load(fh)["polynomial_2d"]


@pytest.mark.parametrize("pc,pf", [(1, 2), (3, 4), (6, 7)])
def test_p_transfer_matches_jax(pc, pf):
    jt = jmake_p_transfer(JSpace(JMesh(2, 2), pc), JSpace(JMesh(2, 2), pf),
                          jnp.float64)
    coarse, fine = FESpace(HyperCubeMesh(2, 2), pc), FESpace(HyperCubeMesh(2, 2), pf)
    tt = make_p_transfer(coarse, fine, torch.float64)
    rng = np.random.default_rng(pf)
    f = rng.standard_normal(fine.grid_shape)
    c = rng.standard_normal(coarse.grid_shape)
    Pc = tt.prolongate(torch.as_tensor(c))
    Rf = tt.restrict(torch.as_tensor(f))
    assert _rel(jt.prolongate(jnp.asarray(c)), Pc) < 1e-13
    assert _rel(jt.restrict(jnp.asarray(f)), Rf) < 1e-13
    lhs = float((Pc * torch.as_tensor(f)).sum())
    rhs = float((torch.as_tensor(c) * Rf).sum())
    assert lhs == pytest.approx(rhs, rel=1e-13)


def test_p_transfer_rejects_two_meshes():
    with pytest.raises(ValueError, match="same mesh"):
        make_p_transfer(FESpace(HyperCubeMesh(2, 1), 1),
                        FESpace(HyperCubeMesh(2, 2), 2))


@pytest.mark.parametrize("row", _golden(),
                         ids=lambda r: f"p{r['degree']}-L{r['levels']}-r{r['refinements']}")
def test_golden_rows(row):
    prob = PolynomialMultigridPoisson(2, row["degree"], row["refinements"],
                                      row["levels"], torch.float64, "auto",
                                      device="cpu")
    assert all(isinstance(lvl.op, CudaLaplace2D) for lvl in prob.levels)
    _, st = prob.solve()
    assert st.converged and st.iterations == row["iterations"]
    assert st.n_dofs == row["n_dofs"]
    assert st.solution_l2_norm == pytest.approx(row["l2_norm"], rel=1e-10)


def same_solve(st, jst):
    """The port's solve stats equal the JAX package's."""
    assert st.converged and jst.converged
    assert st.iterations == jst.iterations
    assert st.n_dofs == jst.n_dofs and st.dofs_per_level == jst.dofs_per_level
    assert st.solution_l2_norm == pytest.approx(jst.solution_l2_norm, rel=1e-10)


def check_ladder_matches_jax(degree, levels, r):
    _, jst = JPolynomial(2, degree, r, levels, jnp.float64, "sumfac").solve()
    _, st = PolynomialMultigridPoisson(2, degree, r, levels, torch.float64,
                                       "auto", device="cpu").solve()
    same_solve(st, jst)


def test_geometric_2d_matches_jax():
    _, jst = JGeometric(2, 2, 2, jnp.float64, "sumfac").solve()
    prob = GeometricMultigridPoisson(2, 2, 2, torch.float64, "auto",
                                     device="cpu")
    # plain h-transfers, adapted to the trimmed levels
    assert all(isinstance(lvl.transfer, TrimmedTransfer)
               for lvl in prob.levels[1:])
    same_solve(prob.solve()[1], jst)


def test_kron_ladder_matches_auto():
    _, a = PolynomialMultigridPoisson(2, 4, 2, 3, torch.float64, "auto",
                                      device="cpu").solve()
    _, k = PolynomialMultigridPoisson(2, 4, 2, 3, torch.float64, "kron",
                                      device="cpu").solve()
    assert a.iterations == k.iterations
    assert a.solution_l2_norm == pytest.approx(k.solution_l2_norm, rel=1e-12)


def test_n_levels_checked():
    with pytest.raises(ValueError, match="n_levels"):
        PolynomialMultigridPoisson(2, 2, 1, 3, device="cpu")
    # n_levels defaults to degree
    prob = PolynomialMultigridPoisson(2, 3, 1, device="cpu")
    assert [sp.degree for sp in prob.spaces] == [1, 2, 3]


def test_vcycle_from_jax_state_matches():
    """Carry-across: the port's kernel levels (fused smoothers on trimmed
    state, plain p-transfers) rebuilt from the JAX kron ladder's level state
    give the JAX V-cycle."""
    jprob = JPolynomial(2, 3, 2, 3, jnp.float64, "kron")
    levels = []
    for i, jl in enumerate(jprob.levels):
        jop = jl.op
        op = convert.kernel_operator(
            dim=2, degree=jop.degree, n=jop.n[0],
            mask1=np.asarray(jop.mask1[0]), dK1=np.asarray(jop.dK1[0]),
            dM1=np.asarray(jop.dM1[0]), K1=np.asarray(jop.Kg[0]),
            M1=np.asarray(jop.Mg[0]))
        sm = convert.smoother(op, degree=jl.smoother.degree,
                              theta=jl.smoother.theta, delta=jl.smoother.delta,
                              fused=i > 0)
        tr = None
        if i > 0:
            jt = jl.transfer
            tr = convert.plain_transfer(
                dim=2, n_coarse=jt.n_coarse[0], stride_c=jt.stride_c,
                stride_f=jt.stride_f, M1=np.asarray(jt.M1),
                wmask_f=np.asarray(jt.wmask_f[0]),
                mask_c1=np.asarray(jt.mask_c1[0]))
        levels.append(MGLevel(op=op, smoother=sm, transfer=tr))
    levels, fine_trimmed = wire_trimmed(levels)
    assert fine_trimmed
    mg = VCycle(levels=tuple(levels), fine_trimmed=True)
    sp = jprob.spaces[-1]
    b = np.random.default_rng(4).standard_normal(sp.grid_shape) * sp.free_mask()
    want = JVCycle(levels=jprob.levels).apply(jnp.asarray(b))
    assert _rel(want, mg.apply(torch.as_tensor(b))) < 1e-12


def test_driver_prints_reference_format():
    """The lines of the JAX driver, with the port's numbers; cycle 1 is the
    Q3 3-level r=2 ladder that test_torch_pmg_ladders.py holds against the
    JAX package."""
    proc = subprocess.run(
        [sys.executable, "-m",
         "portable_multigrid_tpu_torch.programs.polynomial_multigrid",
         "--degree", "3", "--levels", "3", "--cycles", "2", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "============== fe_degree = 3, mg_levels = 3 ==============" in out
    assert out.count("Cycle ") == 2
    for r in (1, 2):
        _, jst = PolynomialMultigridPoisson(2, 3, r, 3, device="cpu").solve()
        dofs = ", ".join(str(d) for d in jst.dofs_per_level)
        assert (f" Number of degrees of freedom: {jst.n_dofs} (by level: "
                f"{dofs})") in out
        assert f"  Solver converged in {jst.iterations} iterations." in out
        assert f"  solution norm: {jst.solution_l2_norm:.6g}" in out
