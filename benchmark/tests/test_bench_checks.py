"""The check that decides ``correct`` (``pmgbench/check.py``) at tiny
sizes on the CPU, with the real cells' limits: sound runs pass; the
control (the plain reference in the precision below CG's, put in the
place of the program's operator) and the faults of the timed path fail."""

import dataclasses

import pytest
import torch

import calibrate
import run
from pmgbench import session, spec

CELLS = {"tiny3d.rhs_stream": "poisson3d_q4_r6.rhs_stream",
         "tiny3d.f64_tight": "poisson3d_q4_r6.f64_tight",
         "tiny2d.rhs_stream": "poisson2d_q7_r9.rhs_stream"}


def execute(checkout, workload, seed=2**31 + 11):
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", "0.4", "--trace", "0"])
    return run.execute(args, "cpu", root=checkout)


def test_limits_are_set(checkout):
    for real in CELLS.values():
        checks = spec.load_cell(checkout, real).checks
        limits = checks["limits"]
        assert {"error", "failed"} <= set(limits) and limits["failed"] == 0
        # every limit lies between its two readings, nearer the control
        for name, limit in limits.items():
            if name == "failed":
                continue
            r = checks["readings"][name]
            assert r["lower"] < limit < r["control_least"]
            assert limit / r["lower"] > r["control_least"] / limit


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_is_not_correct(checkout, workload, monkeypatch):
    cell = spec.load_cell(checkout, workload)
    A = calibrate.control_operator(cell, torch.device("cpu"))
    program = session.Session.callables
    monkeypatch.setattr(session.Session, "callables",
                        lambda self: (A, program(self)[1]))
    out = execute(checkout, workload)
    assert out["correct"] is False
    c = out["checks"]["error"]
    assert c["value"] > c["limit"]


def _zero(x):
    return torch.zeros_like(x)


def _altered(x):
    y = x.clone().reshape(-1)
    k = y.numel() // 2 + 1
    y[k] += 1e-2 * x.abs().max()
    return y.reshape(x.shape)


def _half(x):
    y = x.clone().reshape(-1)
    y[: y.numel() // 2] = 0
    return y.reshape(x.shape)


@pytest.mark.parametrize("fault", ["operator_returns_input", "state_unchanged",
                                   "answer_altered", "half_left_out"])
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_fault_is_not_correct(checkout, workload, fault, monkeypatch):
    if fault == "operator_returns_input":
        program = session.Session.callables
        monkeypatch.setattr(session.Session, "callables",
                            lambda self: (lambda v: v, program(self)[1]))
    else:
        change = {"state_unchanged": _zero, "answer_altered": _altered,
                  "half_left_out": _half}[fault]
        solve = session.Session.solve

        def broken(self, b, A=None, M=None):
            res = solve(self, b, A, M)
            return dataclasses.replace(res, x=change(res.x))

        monkeypatch.setattr(session.Session, "solve", broken)
    assert execute(checkout, workload)["correct"] is False


def test_sound_runs_are_correct_on_many_seeds(checkout):
    for seed in (1, 2**31 - 1, 2**31 + 99):
        for workload in sorted(CELLS):
            assert execute(checkout, workload, seed)["correct"] is True


SHARDED = "tiny_sharded3d.f64_tight"


def _right_copy_off(parts):
    """The right owner's copy of the first shared plane off by 1% of max
    |x|."""
    top = max(float(t.abs().max()) for t in parts)
    out = [t.clone() for t in parts]
    out[1][0] += 1e-2 * top
    return out


def _slab_zeroed(parts):
    return [torch.zeros_like(t) if s == 2 else t
            for s, t in enumerate(parts)]


def _all_zero(parts):
    return [torch.zeros_like(t) for t in parts]


def test_sharded_sound_runs_are_correct(sharded_checkout):
    for seed in (5, 2**31 + 7):
        out = execute(sharded_checkout, SHARDED, seed)
        assert out["correct"] is True, out["checks"]
        assert out["checks"]["shared_planes"]["value"] == 0.0


def test_sharded_control_is_not_correct(sharded_checkout, monkeypatch):
    """The float32 reference operator, gathered and re-slabbed, in the
    place of the sharded float64 operator."""
    cell = spec.load_cell(sharded_checkout, SHARDED)
    A = calibrate.control_operator(cell, torch.device("cpu"))
    program = session.Session.callables
    monkeypatch.setattr(session.Session, "callables",
                        lambda self: (A, program(self)[1]))
    out = execute(sharded_checkout, SHARDED)
    assert out["correct"] is False
    c = out["checks"]["error"]
    assert c["value"] > c["limit"]


@pytest.mark.parametrize("fault", ["right_copy_off", "slab_zeroed",
                                   "all_zero"])
def test_sharded_fault_is_not_correct(sharded_checkout, fault, monkeypatch):
    """A fault planted in the solution that the timed path hands back, as
    the slabs the harness keeps."""
    change = {"right_copy_off": _right_copy_off, "slab_zeroed": _slab_zeroed,
              "all_zero": _all_zero}[fault]
    held = session.Session.held
    monkeypatch.setattr(session.Session, "held",
                        lambda self, x: change(held(self, x)))
    out = execute(sharded_checkout, SHARDED)
    assert out["correct"] is False
    failing = {k for k, c in out["checks"].items() if c["value"] > c["limit"]}
    if fault == "right_copy_off":
        # the gathered x takes the left owner's copy: only the copies'
        # difference shows the fault
        assert failing == {"shared_planes"}
        assert out["checks"]["shared_planes"]["value"] == pytest.approx(
            1e-2, rel=1e-6)
    else:
        assert "error" in failing
