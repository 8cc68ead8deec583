"""On-card checks of the general-geometry path (marked ``requires_cuda``):
every indexed operator kind and its transfer on the card against the port
on the CPU and bit for bit repeatable, the small model solves against
their dense oracles with the graphed solve equal to the eager one, the
curved solves' CG counts, and driver 3 on the card.  These skip on a
machine without a card; phase 19 of ``python3 chip_smoke.py`` runs them
and the full-width cases."""

import math
import os
import subprocess
import sys

import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.requires_cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def test_operators_match_cpu_bitwise_repeatable(cuda):
    """Apply, prolongate and restrict of the Cartesian, perturbed, curved
    and unstructured operators within GENERAL_BOUND of the CPU, two calls
    bit for bit equal."""
    chip_smoke.general_compare(cuda)


def test_solves_match_dense_graph_equals_eager(cuda):
    chip_smoke.general_dense_solves(cuda)


def test_curved_counts_and_rate(cuda):
    errs = []
    for r in (2, 3):
        _, _, st, err = chip_smoke.curved_solve(r, cuda)
        assert st.iterations == chip_smoke.CURVED_JAX_CG[r]
        errs.append(err)
    assert math.log2(errs[0] / errs[1]) > 3 + chip_smoke.CURVED_RATE_MARGIN


def test_driver3_on_the_card(cuda, tmp_path):
    vtu = os.path.join(tmp_path, "u.vtu")
    proc = subprocess.run(
        [sys.executable, "-m",
         "portable_multigrid_tpu_torch.programs.unstructured_multigrid",
         "--dim", "3", "--degree", "2", "--refinements", "1", "--vtu", vtu],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Solver converged in" in proc.stdout
    assert "DoF enumerator: native" in proc.stdout
    assert os.path.exists(vtu)
