"""A new configuration, traffic mix and per-layer metric are new files and
new ``BENCHMARK.json`` entries: the harness finds them by name, with no
file of the benchmark edited."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, add_sharded_cell, make_checkout


def digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()}


def scalar_cell(root, bench):
    """A Q3 Poisson configuration under a new, looser traffic mix, with a
    new per-layer metric; returns (workload, files added)."""
    here = root / "benchmark"
    cfg = json.loads((here / "configs" / "tiny3d.json").read_text())
    cfg.update(name="tiny3d_q3", degree=3)
    cfg["n_dofs"] = 13 ** 3
    for model in cfg["models"].values():
        model["kwargs"]["degree"] = 3
    (here / "configs" / "tiny3d_q3.json").write_text(json.dumps(cfg))
    mix = json.loads((here / "traffic" / "rhs_stream.json").read_text())
    mix.update(name="loose", rtol=1e-3)
    (here / "traffic" / "loose.json").write_text(json.dumps(mix))
    (here / "checks" / "tiny3d_q3.loose.json").write_text(
        json.dumps({"limits": {"failed": 0}}))
    (here / "metrics" / "solve_ms_max.py").write_text(
        "def read(run):\n    return 1e3 * max(run.window.solve_s)\n")
    bench["configs"].append({"name": "tiny3d_q3", "source": "test",
                             "file": "benchmark/configs/tiny3d_q3.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny3d_q3.loose",
                               "config": "tiny3d_q3", "traffic": "loose",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "solve_ms_max", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "CG: solvers/cg.py",
                               "moves": "solve_ms_p95",
                               "workloads": ["tiny3d_q3.loose"]})
    return "tiny3d_q3.loose", {
        "configs/tiny3d_q3.json", "traffic/loose.json",
        "checks/tiny3d_q3.loose.json", "metrics/solve_ms_max.py"}


def vector_cell(root, bench):
    """A vector-valued configuration (3D Q2 linear elasticity, three
    displacement components) under the existing ``f64_tight`` mix, with
    a plain reference of its own (``elasticity_dense.py``) and a checks
    file; every per-layer metric lists the new cell."""
    here = root / "benchmark"
    kwargs = {"dim": 3, "degree": 2, "refinements": 2, "mu": 0.7,
              "lam": 1.3, "dtype": "float64", "variant": "auto"}
    cfg = {"name": "tiny_elastic3d", "dim": 3, "degree": 2,
           "refinements": 2, "components": 3, "mu": 0.7, "lam": 1.3,
           "n_dofs": 3 * 9 ** 3, "reference": "elasticity_dense",
           "models": {"float64": {"class": "ElasticityMultigrid",
                                  "kwargs": kwargs}}}
    (here / "configs" / "tiny_elastic3d.json").write_text(json.dumps(cfg))
    shutil.copy(BENCH / "tests" / "elasticity_dense.py",
                here / "configs" / "elasticity_dense.py")
    cell = "tiny_elastic3d.f64_tight"
    (here / "checks" / f"{cell}.json").write_text(
        json.dumps({"limits": {"error": 1e-8, "failed": 0}}))
    bench["configs"].append({"name": "tiny_elastic3d", "source": "test",
                             "file": "benchmark/configs/tiny_elastic3d.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": "tiny_elastic3d",
                               "traffic": "f64_tight", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append(cell)
    return cell, {"configs/tiny_elastic3d.json",
                  "configs/elasticity_dense.py", f"checks/{cell}.json"}


@pytest.mark.parametrize("make_cell", [scalar_cell, vector_cell,
                                       add_sharded_cell],
                         ids=["scalar", "vector", "sharded"])
def test_new_cell_from_new_files(tmp_path, make_cell):
    root = make_checkout(tmp_path)
    here = root / "benchmark"
    before = digests(here)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    workload, files = make_cell(root, bench)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    added = {p for p in digests(here)} - set(before)
    assert {str(p) for p in added} == files
    assert all(digests(here)[p] == d for p, d in before.items())

    # the copy's own harness runs the new cell, on the CPU
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import run; print(json.dumps(run.execute(run.parse(["
            f"'--workload', '{workload}', '--seed', '3', '--seconds', "
            "'0.3', '--trace', '1']), 'cpu')))")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PMG_")}
    res = subprocess.run([sys.executable, "-c", code, str(here), str(ROOT)],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    if make_cell is scalar_cell:
        assert out["metrics"]["solve_ms_max"]["unit"] == "ms"
        assert "cg_iterations" not in out["metrics"]  # listed for others
    else:
        assert out["checks"]["error"]["limit"] == 1e-8
        assert out["checks"]["error"]["value"] <= 1e-8
        # on the CPU the readers of device numbers find nothing to read
        assert set(out["metrics"]) == {"hierarchy_build_s", "cg_iterations"}
    if make_cell is add_sharded_cell:
        # four slabs whose shared planes agree; no card on the CPU
        assert out["checks"]["shared_planes"] == {"value": 0.0, "limit": 0.0}
        assert out["device"]["count"] == 4
        assert out["device"]["memory_peak_bytes_per_card"] == []
        assert out["device"]["busy_s_per_card"] == []
