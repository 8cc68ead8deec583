"""The port's own spans (``utils/profiling.py``): the V-cycle's device span
plan in V(2,2) order with its parents and levels, on a 3D h-hierarchy, a 2D
p-ladder and a mixed-precision model; nothing recorded, no range in a
profile and no marker while tracing is off; ``pmg.cg.host_read`` once before
CG's loop and once an iteration, with the stopping decisions of the former
two-read loop; ``SpanPlan.times``'s self-time arithmetic; the benchmark's
reducer of the program's spans (``benchmark/pmgbench/program_trace.py``) on
a synthetic trace with known answers.  The ``requires_cuda`` test holds a
traced ``GraphedVCycle`` on the card: span times against the replay's
CUDA-event time, and the untraced capture's launches unchanged."""

import sys
from pathlib import Path

import pytest
import torch

from portable_multigrid_tpu_torch import (
    GeometricMultigridPoisson,
    MixedPrecisionPoisson,
    PolynomialMultigridPoisson,
)
from portable_multigrid_tpu_torch.ops import (
    cuda_cheb2,
    cuda_laplace,
    cuda_laplace2d,
    cuda_transfer,
)
from portable_multigrid_tpu_torch.solvers.cg import cg
from portable_multigrid_tpu_torch.utils import profiling

sys.path.append(str(Path(__file__).resolve().parent.parent / "benchmark"))
from pmgbench import program_trace  # noqa: E402

torch.set_num_threads(1)

MODELS = {
    "3d_h": lambda dev: GeometricMultigridPoisson(
        3, 2, 2, dtype=torch.float64, device=dev),
    "2d_p": lambda dev: PolynomialMultigridPoisson(
        2, 3, 2, dtype=torch.float64, device=dev),
    "mixed": lambda dev: MixedPrecisionPoisson(3, 2, 2, device=dev),
}


def expected_plan(n_levels: int, io: bool) -> list:
    """(event, name, level) of a V(2,2) cycle's device spans in marker
    order; ``levels[0]`` is the coarsest."""
    top = n_levels - 1

    def span(name, level=None):
        return [("enter", name, level), ("exit", name, level)]

    out = [("enter", "vcycle", None)]
    out += span("vcycle.io") if io else []
    for lvl in range(top, 0, -1):
        out += span(f"vcycle.L{lvl}.pre", lvl)
        out += span(f"vcycle.L{lvl}.restrict", lvl)
    out += span("vcycle.coarse", 0)
    for lvl in range(1, top + 1):
        out += span(f"vcycle.L{lvl}.prolongate", lvl)
        out += span(f"vcycle.L{lvl}.post", lvl)
    out += span("vcycle.io") if io else []
    return out + [("exit", "vcycle", None)]


def plan_events(plan) -> list:
    ev = {}
    for s in plan.spans:
        ev[s.enter] = ("enter", s.name, s.level)
        ev[s.exit] = ("exit", s.name, s.level)
    assert sorted(ev) == list(range(plan.slots))
    return [ev[k] for k in range(plan.slots)]


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_eager_plan_order_parents_levels(kind):
    model = MODELS[kind]("cpu")
    mg = model.preconditioner()
    b = model.rhs()
    want = mg.apply(b)
    with profiling.tracing() as rec:
        got = mg.apply(b)
    assert torch.equal(got, want)  # spans change no arithmetic
    (plan,) = rec.plans
    assert plan.buffer is None  # no marker on the CPU
    io = mg.fine_trimmed or mg.io_dtype is not None
    assert plan_events(plan) == expected_plan(len(model.levels), io)
    assert plan.spans[0].parent is None
    assert all(s.parent == 0 for s in plan.spans[1:])
    # the host record holds the same spans, nested alike
    assert [s.name for s in rec.spans] == [s.name for s in plan.spans]
    assert [s.level for s in rec.spans] == [s.level for s in plan.spans]
    assert [s.parent for s in rec.spans] == [None] + [0] * (
        len(plan.spans) - 1)
    assert all(s.end_ns >= s.start_ns for s in rec.spans)


def test_tracing_off_records_nothing():
    model = GeometricMultigridPoisson(3, 2, 1, dtype=torch.float64,
                                      device="cpu")
    A, M, b = model.fine_operator.apply, model.preconditioner().apply, \
        model.rhs()
    with profiling.tracing() as rec:
        pass
    marks = profiling.LAUNCHES["mark"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        res = cg(A, b, M, rtol=1e-10)
    names = {ev.name() for ev in prof.profiler.kineto_results.events()}
    assert not [n for n in names if n.startswith(("pmg.", "vcycle"))]
    assert rec.spans == [] and not rec.counts and rec.plans == []
    assert profiling.active() is None
    assert profiling.LAUNCHES["mark"] == marks
    with profiling.tracing() as rec:
        traced = cg(A, b, M, rtol=1e-10)
    assert torch.equal(traced.x, res.x)
    assert traced.iterations == res.iterations


def cg_two_reads(A, b, M, rtol):
    """The former loop: two reads before it, threshold then ||r||."""
    norm = lambda v: torch.sqrt(torch.dot(v.reshape(-1), v.reshape(-1)))
    x = torch.zeros_like(b)
    r = b
    threshold = float(rtol * norm(b))
    res = float(norm(r))
    z = M(r)
    rz = torch.dot(r.reshape(-1), z.reshape(-1))
    p = z.clone()
    it = 0
    while res > threshold and it < 50:
        Ap = A(p)
        alpha = rz / torch.dot(p.reshape(-1), Ap.reshape(-1))
        x = x + alpha * p
        r = r - alpha * Ap
        res_t = norm(r)
        z = M(r)
        rz_new = torch.dot(r.reshape(-1), z.reshape(-1))
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
        res = float(res_t)
    return x, it, res


@pytest.mark.parametrize("dtype,rtols", [(torch.float32, (1e-3, 1e-5)),
                                         (torch.float64, (1e-6, 1e-12))])
def test_host_reads_per_solve(dtype, rtols):
    model = GeometricMultigridPoisson(3, 2, 2, dtype=dtype, device="cpu")
    A, M = model.fine_operator.apply, model.preconditioner().apply
    b = model.rhs()
    with profiling.tracing() as rec:
        results = [cg(A, b, M, rtol=rtol, max_iter=50) for rtol in rtols]
    assert rec.counts[profiling.SOLVE] == len(rtols)
    for solve, (rtol, res) in enumerate(zip(rtols, results)):
        reads = [s for s in rec.spans
                 if s.name == "pmg.cg.host_read" and s.solve == solve]
        assert len(reads) == 1 + res.iterations
        assert all(rec.spans[s.parent].name == profiling.SOLVE
                   for s in reads)
        x, it, r = cg_two_reads(A, b, M, rtol)
        assert (it, r) == (res.iterations, res.residual_norm)
        assert torch.equal(x, res.x)


def synthetic_plan(io: bool):
    """vcycle{[io], L1.pre, coarse, L1.post, [io]} entered on the CPU."""
    plan = profiling.SpanPlan()
    names = ["vcycle.L1.pre", "vcycle.coarse", "vcycle.L1.post"]
    if io:
        names = ["vcycle.io"] + names + ["vcycle.io"]
    plan.enter("vcycle", None)
    for name in names:
        plan.enter(name, None)
        plan.exit()
    plan.exit()
    return plan


def test_span_times_self_arithmetic():
    plan = synthetic_plan(io=True)
    assert plan.slots == 12
    # 2 replays; slot k sums the ns since slot k - 1
    sums = [2, 40, 60, 180, 200, 180, 120, 180, 160, 180, 20, 40]
    t = plan.times(sums)
    total = sum(sums[1:]) / 2 / 1e6
    assert t["vcycle"].ms == pytest.approx(total)
    assert t["vcycle.io"].ms == pytest.approx((60 + 20) / 2 / 1e6)
    assert t["vcycle.L1.pre"].ms == pytest.approx(200 / 2 / 1e6)
    assert t["vcycle.coarse"].ms == pytest.approx(120 / 2 / 1e6)
    assert t["vcycle.L1.post"].ms == pytest.approx(160 / 2 / 1e6)
    children = (60 + 20 + 200 + 120 + 160) / 2 / 1e6
    assert t["vcycle"].self_ms == pytest.approx(total - children)
    assert t["vcycle.coarse"].self_ms == t["vcycle.coarse"].ms
    assert plan.times([0] * 12) == {}


def synthetic_trace():
    """Two replays of the synthetic plan (graph launches 101 and 102,
    markers 10 ns long every 100 ns from 100 and from 1100) with a kernel
    in each level span, two CG kernels, one solve with two host reads, in a
    window of 2000 ns."""
    marker = profiling.MARKER_KERNEL + "(long long*, long long*, int)"
    device = []
    for base, corr in ((0, 101), (1000, 102)):
        device += [(base + 100 * (k + 1), base + 100 * (k + 1) + 10, marker,
                    corr) for k in range(8)]
        device += [(base + 215, base + 285, "k_pre", corr),
                   (base + 420, base + 480, "k_coarse", corr),
                   (base + 610, base + 690, "k_post", corr)]
    device += [(850, 900, "dot", 7), (1900, 1950, "dot", 9)]
    host = [(0, 2000, program_trace.WINDOW, 1),
            (5, 1990, profiling.SOLVE, 1),
            (820, 1090, "pmg.cg.host_read", 1),
            (1810, 1985, "pmg.cg.host_read", 1),
            (830, 840, "cudaStreamSynchronize", 1),
            (0, 2000, "pmg.other_thread", 2)]
    return host, device


def test_program_trace_reducer_known_answers():
    host, device = synthetic_trace()
    t = program_trace.reduce(host, device, synthetic_plan(io=False), {},
                             profiling.MARKER_KERNEL)
    assert (t.replays, t.dropped, t.solves) == (2, 0, 1)
    assert t.replay_s == pytest.approx(2 * 710e-9)
    assert t.replay_busy_s == pytest.approx(2 * 210e-9)
    assert t.replay_idle_share == pytest.approx(1 - 420 / 1420)
    gaps = {k: round(v * 1e9) for k, v in t.idle_gaps.items() if v}
    # the gaps before each replay are its launch's, the second one's
    # though it opens while the host reads
    assert gaps == {program_trace.LAUNCH: 100 + 200, profiling.SOLVE: 40,
                    "pmg.cg.host_read": 140, "vcycle": 720,
                    "vcycle.L1.pre": 40, "vcycle.coarse": 60,
                    "vcycle.L1.post": 20}
    ops = {s: {k: round(v * 1e9) for k, v in d.items()}
           for s, d in t.span_ops.items()}
    assert ops == {"vcycle.L1.pre": {"k_pre": 140},
                   "vcycle.coarse": {"k_coarse": 120},
                   "vcycle.L1.post": {"k_post": 160}}
    # the metric's reader: host-read idle ms per solve
    assert 1e3 * t.idle_gaps["pmg.cg.host_read"] / t.solves == \
        pytest.approx(140e-6)


def test_program_trace_drops_replays_missing_a_marker():
    host, device = synthetic_trace()
    plan = synthetic_plan(io=False)
    # the profiler dropped replay 101's third marker
    t = program_trace.reduce(host, device[:2] + device[3:], plan, {},
                             profiling.MARKER_KERNEL)
    assert (t.replays, t.dropped) == (1, 1)
    assert t.replay_idle_share == pytest.approx(1 - 210 / 710)
    gaps = {k: round(v * 1e9) for k, v in t.idle_gaps.items() if v}
    # replay 101's gaps lie in the graph, their span unknown
    assert gaps["vcycle"] == 360 + (90 + 5 + 115 + 10 + 20 + 90 + 10 + 90)
    assert gaps["pmg.cg.host_read"] == 140
    with pytest.raises(RuntimeError, match="no replay"):
        program_trace.reduce(host, device[1:8] + device[12:], plan, {},
                             profiling.MARKER_KERNEL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


def _launches() -> dict:
    out = {}
    for mod in (cuda_laplace, cuda_cheb2, cuda_transfer, cuda_laplace2d):
        out.update({(mod.__name__, k): v for k, v in mod.LAUNCHES.items()})
    return out


def _delta(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in _launches().items()
            if v != before.get(k, 0)}


@pytest.mark.requires_cuda
def test_traced_graph_on_card(cuda):
    model = GeometricMultigridPoisson(3, 2, 5, dtype=torch.float32,
                                      device=cuda)
    b = model.rhs()
    eager = model.preconditioner(graph=False)
    before = _launches()
    eager.apply(b)
    torch.cuda.synchronize()
    per_cycle = _delta(before)

    graphed = model.preconditioner()
    before, marks = _launches(), profiling.LAUNCHES["mark"]
    plain = graphed.apply(b)
    # warm-up and capture: the eager cycle's kernels twice, no marker
    assert _delta(before) == {k: 2 * v for k, v in per_cycle.items()}
    assert profiling.LAUNCHES["mark"] == marks
    before = _launches()
    with profiling.tracing():
        traced = graphed.apply(b)
        assert _delta(before) == {k: 2 * v for k, v in per_cycle.items()}
        plan = graphed.span_plan
        assert profiling.LAUNCHES["mark"] == marks + 2 * plan.slots
        graphed.span_ms()
        reps = 20
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(reps):
            graphed.apply(b)
        e1.record()
        torch.cuda.synchronize()
        spans = graphed.span_ms()
    assert torch.equal(traced, plain)
    assert len(graphed.capture_seconds) == 2
    event_ms = e0.elapsed_time(e1) / reps
    assert all(v.ms > 0 for v in spans.values())
    whole = spans["vcycle"]
    assert whole.ms == pytest.approx(
        whole.self_ms + sum(v.ms for k, v in spans.items() if k != "vcycle"))
    assert 0.9 * event_ms <= whole.ms <= event_ms
    assert graphed.span_ms() == {}  # read again: no replay since
