"""Helpers of the benchmark's tests: the benchmark's folder and the repo
root on ``sys.path``, and a checkout in a temporary directory with tiny
cells beside the real ones, which the harness runs on the CPU."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]

# tiny copies of the real configurations: (name, real config, degree,
# refinements); their cells take the real cells' traffic and limits
TINY = (("tiny3d", "poisson3d_q4_r6", 2, 2),
        ("tiny2d", "poisson2d_q7_r9", 3, 2))


def make_checkout(dest: Path) -> Path:
    """A checkout at ``dest``: BENCHMARK.json and the benchmark's folder
    (tests left out), with a tiny cell for each real cell."""
    shutil.copytree(BENCH, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, real, degree, r in TINY:
        cfg = json.loads((BENCH / "configs" / f"{real}.json").read_text())
        cfg.update(name=name, degree=degree, refinements=r)
        cfg["n_dofs"] = ((1 << r) * degree + 1) ** cfg["dim"]
        for model in cfg["models"].values():
            model["kwargs"].update(degree=degree, refinements=r)
        (dest / "benchmark" / "configs" / f"{name}.json").write_text(
            json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": f"benchmark/configs/{name}.json",
                                 "reduced": ["degree", "refinements"],
                                 "why": "test"})
        for w in [w for w in bench["workloads"] if w["config"] == real]:
            cell = f"{name}.{w['traffic']}"
            bench["workloads"].append(dict(w, name=cell, config=name))
            shutil.copy(BENCH / "checks" / f"{w['name']}.json",
                        dest / "benchmark" / "checks" / f"{cell}.json")
            for m in bench["end_to_end"] + bench["per_layer"]:
                if w["name"] in m.get("workloads", ()):
                    m["workloads"].append(cell)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="session")
def checkout(tmp_path_factory) -> Path:
    return make_checkout(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
