"""The elasticity cell's files: the work counts of B.5's rooflines
(``pmgbench/elasticity_counts.py``) against numbers worked by hand, the
configuration through ``spec.load_cell``, the plain reference
(``configs/elasticity.py``) in the control's precision, and a tiny copy of
the cell run by the harness on the CPU."""

import json
import shutil

import numpy as np
import pytest
import torch

import run
from conftest import BENCH, ROOT, make_checkout
from pmgbench import elasticity_counts, spec
from pmgbench.spec import load_module

CELL = "elasticity3d_q3_r6.rhs_stream"
reference = load_module(BENCH / "configs" / "elasticity.py",
                        "elasticity_reference")


def test_counts_by_hand_q1_r1():
    # Q1 in 3D on 2^3 cells, n = 2: a line takes 2 * 1 = 2 FMAs; a cell
    # 3 components * 12 sweeps * 4 lines * 2 + 8 points * (18 + 3 + 6)
    assert elasticity_counts.cell_fmas(3, 1) == 288 + 216 == 504
    assert elasticity_counts.apply_fmas(3, 1, 1) == 8 * 504
    # 3 x 3^3 points, read and written once
    assert elasticity_counts.apply_bytes(3, 1, 1, "float32") == 2 * 81 * 4
    s, by = elasticity_counts.apply_bound_s(3, 1, 1, "float32")
    # bytes 648 / 3.35e12 = 0.193 ns against 2 * 4032 / 67e12 = 0.120 ns
    assert by == "bytes" and s == pytest.approx(648 / 3.35e12)
    # 2D Q2 on 2^2 cells, n = 3: a line 3 * 2 = 6 FMAs; a cell 2 * 8 * 3 * 6
    # + 9 * (8 + 2 + 3)
    assert elasticity_counts.cell_fmas(2, 2) == 288 + 117


def test_counts_at_the_cell():
    # Q3, n = 4: 3 * 12 * 16 * 8 + 64 * 27 = 6336 FMAs a cell, 64^3 cells
    assert elasticity_counts.cell_fmas(3, 3) == 6336
    assert elasticity_counts.apply_fmas(3, 3, 6) == 262144 * 6336
    assert (elasticity_counts.apply_bytes(3, 3, 6, "float32")
            == 2 * 3 * 193 ** 3 * 4 == 172537368)
    s, by = elasticity_counts.apply_bound_s(3, 3, 6, "float32")
    # 51.50 us of bytes against 2 * 1.661e9 / 67e12 = 49.58 us of FMAs
    assert by == "bytes" and s == pytest.approx(5.1504e-5, rel=1e-4)
    assert 2 * 262144 * 6336 / 67e12 == pytest.approx(4.9580e-5, rel=1e-4)
    # V(2,2), Chebyshev(5): 16 recurrence steps and 4 residuals a level
    assert elasticity_counts.smoothing_applications() == {
        "recurrence": 16, "residual": 4}
    assert elasticity_counts.smoothing_applications(3, 1, 1) == {
        "recurrence": 4, "residual": 2}


def test_configuration_loads():
    cell = spec.load_cell(ROOT, CELL)
    c = cell.config
    assert cell.chips == 1 and c["reduced"] == []
    assert (c["dim"], c["degree"], c["refinements"], c["levels"],
            c["components"]) == (3, 3, 6, 7, 3)
    assert c["n_dofs"] == 3 * 193 ** 3 == 21567171
    assert (c["mu"], c["lam"]) == (0.7, 1.3)
    model = cell.model_spec()
    assert model["class"] == "ElasticityMultigrid"
    assert model["kwargs"] == {"dim": 3, "degree": 3, "refinements": 6,
                               "mu": 0.7, "lam": 1.3, "dtype": "float32",
                               "variant": "auto"}
    assert {a["key"] for a in c["assumed"]} == {"mu", "lam"}
    assert cell.reference().make is not None
    names = [m["name"] for m in cell.per_layer]
    assert names == ["elasticity_apply_roofline",
                     "elasticity_smoother_roofline", "elasticity_smoother_ms",
                     "elasticity_cg_iterations"]
    assert [m["name"] for m in cell.end_to_end] == ["solve_dofs_per_s",
                                                    "setup_s"]
    assert cell.checks["limits"]["failed"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bfloat16_reference_keeps_shape_and_dtype(dtype):
    cfg = {"dim": 3, "degree": 3, "refinements": 1, "mu": 0.7, "lam": 1.3}
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (3, 7, 7, 7)), dtype=dtype)
    exact = reference.make(cfg, "cpu").apply(x.double())
    low = reference.make(cfg, "cpu", torch.bfloat16)
    assert all(W.dtype == torch.bfloat16 for W in low.mats.values())
    got = low.apply(x)
    assert got.dtype == dtype and got.shape == x.shape
    flat = low.apply(x.reshape(-1))
    assert flat.shape == (3 * 7 ** 3,) and flat.dtype == dtype
    err = float((got.double() - exact).abs().max() / exact.abs().max())
    assert 1e-4 < err < 1e-1, err


def test_tiny_cell_on_the_cpu(tmp_path):
    """A copy of the cell at Q2 r=2 (3 levels), with the real cell's
    traffic, limits and reference, through the harness on the CPU."""
    root = make_checkout(tmp_path)
    here = root / "benchmark"
    cfg = json.loads((BENCH / "configs" / "elasticity3d_q3_r6.json")
                     .read_text())
    cfg.update(name="tiny_el", degree=2, refinements=2, levels=3,
               n_dofs=3 * 9 ** 3)
    cfg["models"]["float32"]["kwargs"].update(degree=2, refinements=2)
    (here / "configs" / "tiny_el.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_el", "source": "test",
                             "file": "benchmark/configs/tiny_el.json",
                             "reduced": ["degree", "refinements"],
                             "why": "test"})
    bench["workloads"].append({"name": "tiny_el.rhs_stream",
                               "config": "tiny_el", "traffic": "rhs_stream",
                               "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tiny_el.rhs_stream")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copy(here / "checks" / f"{CELL}.json",
                here / "checks" / "tiny_el.rhs_stream.json")
    args = run.parse(["--workload", "tiny_el.rhs_stream", "--seed",
                      str(2 ** 33 + 7), "--seconds", "0.3", "--trace", "0"])
    out = run.execute(args, "cpu", root=root)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"solve_dofs_per_s", "setup_s"}
    assert out["checks"]["cg_iterations_max"]["value"] <= 4
