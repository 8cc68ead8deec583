"""What the benchmark reads from the program's own spans.

The program places spans inside itself (``utils/profiling.py``): device
spans in the V-cycle (``vcycle``, ``vcycle.io``, ``vcycle.L<l>.pre``,
``.restrict``, ``.prolongate``, ``.post``, ``vcycle.coarse``), which a
graph captured while tracing is on marks with one marker kernel at each
entry and exit, and host spans in CG (``pmg.cg.solve``,
``pmg.cg.host_read``).  A traced run reads them in a pass of its own after
the traced solves of ``session.py``, which stay as they were: a session
built anew on the card, whose first solve, discarded, captures the traced
graph, then the run's first ``traced_solves`` right-hand sides solved under
``profiling.tracing()``, first alone and then again under
``torch.profiler``, the profiled solves between a host span
``bench.program_window``.  From it:

  * ``GraphedVCycle.span_ms()`` of the solves without the profiler: each
    span's device ms per V-cycle, on the device clock, from the markers'
    sums (the profiler's own work slows a graph of small kernels: the 2D
    coarse solve reads 25% longer under it);
  * the idle share of the profiled replays: over each replay, from its
    first marker to its last, 1 - the union of the device's kernel, copy
    and set intervals other than markers, over that interval.  A replay's
    device events carry the correlation id of its graph launch, and its
    k-th marker is slot k of the graph's plan; a replay of which the
    profiler dropped a marker is left out;
  * the idle gaps of the pass's window, each labelled by what enclosed its
    start: the innermost device span of the replay it lies in; else
    ``(graph launch)`` where the gap ends at a replay's first marker (the
    card waits for the graph to start, whatever the host does meanwhile);
    else the innermost ``pmg.*`` host span of the main thread (what the
    program was doing while the card waited), else ``(no pmg span)``;
  * the device time of each kernel by the device span it ran in.

A program without these spans (an older one) gives nothing, nor does a
run on the CPU, where no marker runs, or a preconditioner that is no CUDA
graph (a multi-card cell's eager sharded V-cycle).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

from .session import Session, synchronize
from .trace import _end, _is_device_work, _label_gaps, _union

WINDOW = "bench.program_window"
NO_SPAN = "(no pmg span)"
LAUNCH = "(graph launch)"


@dataclasses.dataclass
class ProgramTrace:
    span_ms: dict  # span name -> (ms, self ms) per V-cycle, span_ms()
    replays: int  # V-cycle replays in the window with every marker
    dropped: int  # replays of which the profiler dropped a marker
    replay_s: float  # their summed length, first marker to last
    replay_busy_s: float  # device work other than markers inside them
    solves: int  # pmg.cg.solve spans in the window
    idle_gaps: dict  # label -> idle seconds over the window
    span_ops: dict  # device span -> {kernel name: seconds}

    @property
    def replay_idle_share(self) -> float:
        return 1 - self.replay_busy_s / self.replay_s


def supported() -> bool:
    """Whether the program places the spans this module reads."""
    from portable_multigrid_tpu_torch.solvers.vcycle import GraphedVCycle
    from portable_multigrid_tpu_torch.utils import profiling

    return hasattr(profiling, "tracing") and hasattr(GraphedVCycle,
                                                     "span_ms")


def of(run) -> ProgramTrace | None:
    """The program trace of a traced run (``session.RunRecord``), made at
    the first call and kept on the record; None on the CPU, without the
    traced solves, where the program places no spans, or where the
    preconditioner is no CUDA graph."""
    if "program_trace" not in vars(run):
        stream = run.window.stream
        made = None
        if (run.trace is not None and run.graph_capture_s is not None
                and stream.device.type == "cuda" and supported()):
            made = traced_program(run.cell, stream,
                                  int(run.cell.traffic["traced_solves"]))
        run.program_trace = made
    return run.program_trace


def traced_program(cell, stream, solves: int) -> ProgramTrace:
    """``solves`` solves of ``stream``'s first right-hand sides through a
    session built anew, under ``profiling.tracing()`` and
    ``torch.profiler``; the session is released before it returns."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from portable_multigrid_tpu_torch.utils import profiling

    session = Session(cell, stream.device)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        with profiling.tracing():
            # a first, discarded profile starts the profiler's device
            # tracing; its solve captures the traced graph
            with profile(activities=activities):
                session.solve(stream.constant_rhs())
                synchronize(session.devices)
            rhs = [stream.rhs(k % len(stream.coefficients))
                   for k in range(solves)]
            session.precond.span_ms()  # the warm-up's replays are dropped
            for b in rhs:
                session.solve(b)
            span_ms = session.precond.span_ms()
            with profile(activities=activities) as prof:
                with record_function(WINDOW):
                    for b in rhs:
                        session.solve(b)
                    synchronize(session.devices)
            plan = session.precond.span_plan
    finally:
        session.release()
    host, device = events(prof.profiler.kineto_results)
    return reduce(host, device, plan, span_ms, profiling.MARKER_KERNEL)


def events(kineto_results) -> tuple[list, list]:
    """(host, device) of a profile: host events as (start, end, name,
    thread), the device's kernels, copies and sets as (start, end, name,
    correlation id of the launching call), in ns."""
    host, device = [], []
    for ev in kineto_results.events():
        if "cuda" in str(ev.device_type()).lower():
            if _is_device_work(ev):
                device.append((ev.start_ns(), _end(ev), ev.name(),
                               ev.correlation_id()))
        else:
            host.append((ev.start_ns(), _end(ev), ev.name(),
                         ev.start_thread_id()))
    return host, device


def _innermost(plan) -> list:
    """For each interval between slot k - 1 and slot k of a replay (index
    k), the name of the innermost span of ``plan`` open over it."""
    names = [None] * plan.slots
    for k in range(1, plan.slots):
        open_ = [s for s in plan.spans if s.enter < k <= s.exit]
        if open_:
            names[k] = max(open_, key=lambda s: s.enter).name
    return names


def reduce(host, device, plan, span_ms: dict, marker: str) -> ProgramTrace:
    """Reduce one window's events (see :func:`events`); ``plan`` is the
    traced graph's ``SpanPlan`` (its ``slots`` markers a replay, its
    ``spans`` with their entry and exit slots) and ``marker`` the marker
    kernel's name."""
    windows = [h for h in host if h[2] == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} {WINDOW} spans")
    w0, w1, _, main = windows[0]
    inside = [(max(s, w0), min(e, w1), name, corr)
              for s, e, name, corr in device if e > w0 and s < w1]
    launches = collections.defaultdict(list)
    for s, e, name, corr in inside:
        if marker in name:
            launches[corr].append((s, e))
    work = sorted((s, e, name) for s, e, name, _ in inside
                  if marker not in name)
    n = plan.slots
    replays = sorted(sorted(m) for m in launches.values())
    if not any(len(m) == n for m in replays):
        raise RuntimeError(f"no replay in the window holds the plan's {n} "
                           f"markers")
    bounds = [(m[0][0], m[-1][1]) for m in replays]
    whole = [len(m) == n for m in replays]
    starts = [[s for s, _ in m] for m in replays]

    # the busy time of the whole replays, markers left out
    merged = _union((s, e) for s, e, _ in work)
    ends = [e for _, e in merged]
    replay_busy = 0
    for (a, b), ok in zip(bounds, whole):
        i = bisect.bisect_right(ends, a)
        while ok and i < len(merged) and merged[i][0] < b:
            replay_busy += min(merged[i][1], b) - max(merged[i][0], a)
            i += 1

    # where a device instant lies: the innermost span of its replay
    inner = _innermost(plan)

    def span_at(t):
        r = bisect.bisect_right(bounds, (t, float("inf"))) - 1
        if r < 0 or t >= bounds[r][1]:
            return None
        if not whole[r]:
            return "vcycle"
        k = bisect.bisect_right(starts[r], t)
        return inner[k] if 0 < k < n else None

    ops = collections.defaultdict(collections.Counter)
    for s, e, name in work:
        span = span_at(s)
        if span is not None:
            ops[span][name] += (e - s) / 1e9

    busy = _union((s, e) for s, e, _, _ in inside)
    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    if busy:
        gaps = [(w0, busy[0][0])] + gaps + [(busy[-1][1], w1)]
    gaps = [g for g in gaps if g[1] > g[0]]
    in_graph = collections.Counter()
    outside = []
    first = {a for a, _ in bounds}
    for g in gaps:
        span = LAUNCH if g[1] in first else span_at(g[0])
        if span is None:
            outside.append(g)
        else:
            in_graph[span] += (g[1] - g[0]) / 1e9
    pmg = [(s, e, name) for s, e, name, thread in host
           if thread == main and name.startswith("pmg.")]
    labels = _label_gaps(outside, pmg)
    labels[NO_SPAN] = labels.pop("(no host event)", 0.0)
    labels.update(in_graph)
    solves = sum(1 for s, e, name, thread in host
                 if name == "pmg.cg.solve" and w0 <= s and e <= w1)
    return ProgramTrace(
        span_ms={k: tuple(v) for k, v in span_ms.items()},
        replays=sum(whole), dropped=len(whole) - sum(whole),
        replay_s=sum(b - a for (a, b), ok in zip(bounds, whole) if ok) / 1e9,
        replay_busy_s=replay_busy / 1e9, solves=solves,
        idle_gaps=dict(labels), span_ops={k: dict(v) for k, v in ops.items()})
