"""The whole slice: the port's GeometricMultigridPoisson against the JAX
package and the golden convergence table, on CPU (the kernel wrappers run
their plain twins), plus the no-JAX import rule and the driver."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.models.poisson import (
    GeometricMultigridPoisson as JPoisson,
)
from portable_multigrid_tpu_torch import GeometricMultigridPoisson

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden_convergence.json")


def _golden():
    with open(GOLDEN) as fh:
        return {(r["degree"], r["refinements"]): r
                for r in json.load(fh)["geometric_3d"]}


def test_slice_matches_jax_q4_r2():
    jx, jst = JPoisson(3, 4, 2, jnp.float64, "auto").solve()
    x, st = GeometricMultigridPoisson(3, 4, 2, torch.float64, "auto",
                                      device="cpu").solve()
    assert st.converged and jst.converged
    assert st.iterations == jst.iterations
    assert st.n_dofs == jst.n_dofs and st.dofs_per_level == jst.dofs_per_level
    assert st.solution_l2_norm == pytest.approx(jst.solution_l2_norm, rel=1e-10)
    jx = np.asarray(jx)
    assert np.abs(jx - x.numpy()).max() <= 1e-9 * np.abs(jx).max()


@pytest.mark.parametrize("degree,refinements", sorted(_golden()))
def test_golden_table(degree, refinements):
    """Every geometric_3d golden row through the kernel path (twins on CPU):
    CG counts exactly, L2 norms to 1e-10."""
    want = _golden()[(degree, refinements)]
    _, st = GeometricMultigridPoisson(3, degree, refinements, torch.float64,
                                      "auto", device="cpu").solve()
    assert st.converged
    assert st.iterations == want["iterations"]
    assert st.solution_l2_norm == pytest.approx(want["l2_norm"], rel=1e-10)
    assert st.n_dofs == want["n_dofs"]


@pytest.mark.parametrize("degree", [1, 3])
def test_kron_variant_matches_golden(degree):
    want = _golden()[(degree, 2)]
    _, st = GeometricMultigridPoisson(3, degree, 2, torch.float64,
                                      "kron", device="cpu").solve()
    assert st.iterations == want["iterations"]
    assert st.solution_l2_norm == pytest.approx(want["l2_norm"], rel=1e-10)


def test_float32_solve_converges():
    x, st = GeometricMultigridPoisson(3, 4, 2, torch.float32, "auto",
                                      device="cpu").solve(rtol=1e-5)
    assert x.dtype == torch.float32 and st.converged and st.iterations <= 4
    assert st.solution_l2_norm == pytest.approx(
        _golden()[(4, 2)]["l2_norm"], rel=1e-4)


def test_variant_errors():
    with pytest.raises(ValueError, match="2D and 3D"):
        GeometricMultigridPoisson(1, 2, 1, torch.float64, "auto", device="cpu")
    with pytest.raises(ValueError, match="not ported: .*TPU-only"):
        GeometricMultigridPoisson(3, 2, 1, torch.float64, "bkron",
                                  device="cpu")


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import portable_multigrid_tpu_torch\n"
        "import portable_multigrid_tpu_torch.convert\n"
        "import portable_multigrid_tpu_torch._build\n"
        "import portable_multigrid_tpu_torch.models.mixed\n"
        "import portable_multigrid_tpu_torch.solvers.refinement\n"
        "import portable_multigrid_tpu_torch.programs.geometric_multigrid\n"
        "import portable_multigrid_tpu_torch.programs.polynomial_multigrid\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m.startswith('portable_multigrid_tpu.')\n"
        "       or m == 'portable_multigrid_tpu']\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_driver_prints_reference_format():
    proc = subprocess.run(
        [sys.executable, "-m",
         "portable_multigrid_tpu_torch.programs.geometric_multigrid",
         "--max-degree", "2", "--cycles", "2", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = proc.stdout
    assert "============== fe_degree = 2 ==============" in out
    assert "Number of degrees of freedom: 125 (by level: 27, 125)" in out
    assert out.count("Solver converged in") == 4
    assert "solution norm: 0.0233796" in out
