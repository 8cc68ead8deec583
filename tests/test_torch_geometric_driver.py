"""The port's geometric driver against the JAX package's, in 2D (``--dim``):
the same DoF counts, CG counts and printed norms from the two programs, and
the port's L2 norms within 1e-10 of the JAX package's float64 models at
the refinements the JAX driver solves (``refinements = (3 - dim) + cycle +
1``)."""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import pytest

from portable_multigrid_tpu.models.poisson import (
    GeometricMultigridPoisson as JPoisson,
)
from portable_multigrid_tpu_torch.programs import geometric_multigrid

ROOT = os.path.join(os.path.dirname(__file__), "..")
ARGS = ["--dim", "2", "--max-degree", "2", "--cycles", "2"]
PORT = [sys.executable, "-m",
        "portable_multigrid_tpu_torch.programs.geometric_multigrid"]


def _run(cmd):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def _results(out):
    """(degrees of freedom line, CG count, printed norm) of each solve."""
    return list(zip(re.findall(r"Number of degrees of freedom: (.*)", out),
                    re.findall(r"Solver converged in (\d+) iterations", out),
                    re.findall(r"solution norm: (\S+)", out)))


def test_2d_output_matches_the_jax_driver():
    want = _results(_run([sys.executable, "programs/geometric_multigrid.py"]
                         + ARGS))
    got = _results(_run(PORT + ARGS + ["--device", "cpu"]))
    assert len(want) == 4 and got == want


@pytest.mark.parametrize("variant", ["auto", "kron"])
def test_2d_norms_match_the_jax_models(variant, capsys):
    stats = geometric_multigrid.main(ARGS + ["--device", "cpu",
                                             "--variant", variant])
    runs = [(degree, 1 + cycle + 1) for degree in (1, 2) for cycle in (0, 1)]
    assert len(stats) == len(runs)
    for st, (degree, refinements) in zip(stats, runs):
        _, want = JPoisson(2, degree, refinements, dtype=jnp.float64,
                           variant="kron").solve(rtol=1e-12)
        assert st.n_dofs == want.n_dofs
        assert st.iterations == int(want.iterations)
        assert st.solution_l2_norm == pytest.approx(want.solution_l2_norm,
                                                    rel=1e-10)
    assert "Cycle 1" in capsys.readouterr().out
