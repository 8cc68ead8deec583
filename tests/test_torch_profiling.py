"""``utils/profiling.py`` against the JAX package's: ``SolverLog`` records
and prints exactly what the JAX one does; ``measure_op`` returns a
positive slope, hands ``params`` to f, alternates the two counts and stops
when ``progress`` says so; ``trace`` writes a Chrome trace that holds the
``named_scope`` ranges; ``named_scope`` works as a context manager and as a
decorator."""

import glob
import json
import os

import pytest
import torch

from portable_multigrid_tpu.utils import profiling as jprof
from portable_multigrid_tpu_torch.utils import profiling

torch.set_num_threads(1)

RECORDS = [dict(level=3, iterations=4, residual=1.5e-13),
           dict(stage="setup", seconds=0.25, ok=True),
           dict(name="vcycle", dofs=16974593)]


@pytest.mark.parametrize("json_lines", [False, True])
@pytest.mark.parametrize("enabled", [True, False])
def test_solver_log_equals_jax(capsys, enabled, json_lines):
    outs, recs = [], []
    for mod in (jprof, profiling):
        log = mod.SolverLog(enabled=enabled, json_lines=json_lines)
        for rec in RECORDS:
            log.log(**rec)
        outs.append(capsys.readouterr().out)
        recs.append(log.records)
    assert outs[0] == outs[1] and recs[0] == recs[1] == RECORDS
    assert bool(outs[1]) == enabled


def _work():
    a = torch.as_tensor(torch.linspace(-1.0, 1.0, 400 * 400)
                        .reshape(400, 400), dtype=torch.float64) / 40
    return a, (lambda u: torch.tanh(a @ u))


def test_measure_op_slope_is_positive():
    a, f = _work()
    slope = profiling.measure_op(f, a, iterations=(2, 12), repeats=3)
    assert slope > 0


def test_measure_op_passes_params_and_counts():
    """f(params, x) with ``params``; every count runs once untimed, then
    in turns each round."""
    a, _ = _work()
    seen = []

    def f(prm, u):
        seen.append(prm)
        return u * prm["scale"]

    profiling.measure_op(f, a, iterations=(1, 3), params={"scale": 1.0},
                         repeats=2)
    assert len(seen) == (1 + 3) * 3
    assert all(s == {"scale": 1.0} for s in seen)


def test_measure_op_stops_on_progress():
    a, f = _work()
    rounds = []

    def progress(slope, k):
        rounds.append((slope, k))
        return k == 2

    profiling.measure_op(f, a, repeats=5, progress=progress)
    assert [k for _, k in rounds] == [1, 2]
    assert all(isinstance(s, float) for s, _ in rounds)


def test_trace_writes_the_scopes(tmp_path):
    @profiling.named_scope("pmg_decorated")
    def double(t):
        return t * 2

    with profiling.trace(str(tmp_path)) as prof:
        with profiling.named_scope("pmg_block"):
            double(torch.ones(8))
        double(torch.ones(8))
    assert isinstance(prof, torch.profiler.profile)
    files = glob.glob(os.path.join(tmp_path, "trace_*.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    with open(files[0]) as fh:
        names = [e.get("name") for e in json.load(fh)["traceEvents"]]
    assert "pmg_block" in names and names.count("pmg_decorated") == 2


def test_named_scope_nests_and_returns():
    scope = profiling.named_scope("outer")

    @scope
    def recurse(k):
        return 0 if k == 0 else 1 + recurse(k - 1)

    assert recurse(3) == 3
    with profiling.named_scope("inner") as s:
        assert s.name == "inner"
