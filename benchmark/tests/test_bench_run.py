"""A run of a tiny cell on the CPU through ``run.execute``: the result
line's format, the seed's inputs, and the command line's refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import run
from conftest import BENCH, ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def execute(checkout, workload, seed=2**31 + 5, seconds=0.5, trace=0):
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace)])
    return run.execute(args, "cpu", root=checkout)


@pytest.mark.parametrize("workload", ["tiny3d.rhs_stream",
                                      "tiny3d.f64_tight",
                                      "tiny2d.rhs_stream"])
def test_end_to_end_line(checkout, workload, capsys):
    out = execute(checkout, workload)
    assert list(out) == KEYS
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    units = {"solve_dofs_per_s": "DoF/s", "solve_ms_p95": "ms", "setup_s": "s"}
    if workload.startswith("tiny2d"):  # the p-ladder's cell has no tail
        del units["solve_ms_p95"]
    assert {k: v["unit"] for k, v in out["metrics"].items()} == units
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert {"error", "failed"} <= set(out["checks"])
    run.emit(out)
    cap = capsys.readouterr()
    assert json.loads(cap.out.strip().splitlines()[-1]) == json.loads(
        json.dumps(out))
    assert cap.err.strip().splitlines()[-1].startswith("check failed: 0 ")


def test_traced_line(checkout):
    out = execute(checkout, "tiny3d.rhs_stream", trace=1)
    assert list(out) == KEYS[:5] + ["breakdown", "checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert out["device"]["window_s"] > 0
    # on the CPU the readers of device numbers find nothing to read
    assert set(out["metrics"]) == {"hierarchy_build_s", "cg_iterations"}
    assert out["metrics"]["cg_iterations"]["value"] >= 1


def test_same_seed_same_solves(checkout):
    from pmgbench import spec
    from pmgbench.session import Session

    s = Session(spec.load_cell(checkout, "tiny3d.rhs_stream"), "cpu")
    a, b = (s.window(77, 0.3) for _ in range(2))
    n = min(len(a.iterations), len(b.iterations))
    assert a.iterations[:n] == b.iterations[:n]
    assert torch.equal(a.stream.rhs(n - 1), b.stream.rhs(n - 1))


ELASTIC = {"dim": 3, "degree": 2, "refinements": 1, "mu": 0.7, "lam": 1.3,
           "dtype": "float64", "variant": "kron"}


@pytest.mark.parametrize("model,components", [
    ({"class": "ElasticityMultigrid", "kwargs": ELASTIC}, 1),
    ({"class": "GeometricMultigridPoisson",
      "kwargs": {"dim": 3, "degree": 2, "refinements": 1,
                 "dtype": "float64"}}, 3)])
def test_session_refuses_wrong_components(checkout, model, components):
    """A configuration whose right-hand sides do not fit its model fails
    in set-up, naming ``components``."""
    from pmgbench import spec
    from pmgbench.session import Session

    cell = spec.load_cell(checkout, "tiny3d.f64_tight")
    cell.config = {"name": "wrong", "dim": 3, "degree": 2,
                   "refinements": 1, "components": components,
                   "models": {"float64": model}}
    with pytest.raises(ValueError, match=f"components {components}"):
        Session(cell, "cpu")


def _cli(cwd, env):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           "poisson3d_q4_r6.rhs_stream", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_pmg_variable_refused():
    res = _cli(ROOT, dict(os.environ, PMG_CHEB2="0"))
    assert res.returncode == 2 and res.stdout == ""
    assert "PMG_CHEB2" in res.stderr


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PMG_")}
    res = _cli(ROOT, env)
    assert res.returncode != 0 and res.stdout == ""


def test_benchmark_alone_gives_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PMG_") and k != "PYTHONPATH"}
    res = _cli(tmp_path, env)
    assert res.returncode != 0 and res.stdout == ""
