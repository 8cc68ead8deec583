"""A new configuration, traffic mix and per-layer metric are new files and
new ``BENCHMARK.json`` entries: the harness finds them by name, with no
file of the benchmark edited."""

import hashlib
import json
import os
import subprocess
import sys

from conftest import ROOT, make_checkout


def digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()}


def test_new_cell_from_new_files(tmp_path):
    root = make_checkout(tmp_path)
    here = root / "benchmark"
    before = digests(here)
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
    bench = json.loads((root / "BENCHMARK.json").read_text())
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
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    added = {p for p in digests(here)} - set(before)
    assert {str(p) for p in added} == {
        "configs/tiny3d_q3.json", "traffic/loose.json",
        "checks/tiny3d_q3.loose.json", "metrics/solve_ms_max.py"}
    assert all(digests(here)[p] == d for p, d in before.items())

    # the copy's own harness runs the new cell, on the CPU
    code = ("import json, sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import run; print(json.dumps(run.execute(run.parse(["
            "'--workload', 'tiny3d_q3.loose', '--seed', '3', '--seconds', "
            "'0.3', '--trace', '1']), 'cpu')))")
    env = {k: v for k, v in os.environ.items() if not k.startswith("PMG_")}
    res = subprocess.run([sys.executable, "-c", code, str(here), str(ROOT)],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["metrics"]["solve_ms_max"]["unit"] == "ms"
    assert "cg_iterations" not in out["metrics"]  # listed for other cells
