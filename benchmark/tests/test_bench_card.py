"""On the card (marked ``requires_cuda``): the command line runs the main
path's cell for a short window, untraced and traced, and prints a correct
result line on the card."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT

pytestmark = pytest.mark.requires_cuda


@pytest.mark.parametrize("trace", [0, 1])
def test_main_path_cell_on_the_card(cuda, trace):
    env = {k: v for k, v in os.environ.items() if not k.startswith("PMG_")}
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "poisson3d_q4_r6.rhs_stream", "--seed", str(2**31 + 3),
         "--seconds", "3", "--trace", str(trace)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["failed"] == 0
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert list(out)[-1] == "checks"
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
        assert 0 < out["metrics"]["fine_apply_roofline"]["value"] <= 100
