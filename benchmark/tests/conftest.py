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


def add_sharded_cell(root: Path, bench: dict) -> tuple[str, set]:
    """A multi-card configuration (``parallel.ShardedGeometricPoisson``,
    3D Q2 r=3 in float64 on ``sumfac``, four cards: four times the CPU
    here) under the existing ``f64_tight`` mix, with a checks file that
    limits ``error`` and ``shared_planes``, added to ``root``'s benchmark
    and to ``bench`` (every per-layer metric lists the new cell); returns
    (workload, files added)."""
    here = root / "benchmark"
    kwargs = {"dim": 3, "degree": 2, "refinements": 3, "dtype": "float64",
              "variant": "sumfac"}
    cfg = {"name": "tiny_sharded3d", "dim": 3, "degree": 2,
           "refinements": 3, "n_dofs": 17 ** 3, "reference": "laplace",
           "models": {"float64": {"class": "parallel.ShardedGeometricPoisson",
                                  "kwargs": kwargs}}}
    (here / "configs" / "tiny_sharded3d.json").write_text(json.dumps(cfg))
    cell = "tiny_sharded3d.f64_tight"
    (here / "checks" / f"{cell}.json").write_text(json.dumps(
        {"limits": {"error": 1e-8, "shared_planes": 0.0, "failed": 0}}))
    bench["configs"].append({"name": "tiny_sharded3d", "source": "test",
                             "file": "benchmark/configs/tiny_sharded3d.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": "tiny_sharded3d",
                               "traffic": "f64_tight", "chips": 4,
                               "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append(cell)
    return cell, {"configs/tiny_sharded3d.json", f"checks/{cell}.json"}


@pytest.fixture(scope="session")
def sharded_checkout(tmp_path_factory) -> Path:
    """A checkout with :func:`add_sharded_cell`'s cell beside the tiny
    ones."""
    root = make_checkout(tmp_path_factory.mktemp("sharded"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    add_sharded_cell(root, bench)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root
