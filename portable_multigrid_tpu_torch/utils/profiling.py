"""Tracing and profiling helpers.

Counterpart of ``portable_multigrid_tpu/utils/profiling.py``.  The
reference's only observability hook is readable kernel names in
nvprof/Kokkos-Tools (reference:
include/operators/portable_laplace_operator.h:604, :797;
include/multigrid/portable_geometric_transfer.h:804).  Here:

  * :func:`tracing`, the one switch: spans record only inside its block,
    and are off by default;
  * :class:`named_scope`, the one span type.  While tracing is on, a span is
    a ``torch.profiler.record_function`` range (on the profiler's clock, with
    the device's events), an NVTX range in a process that uses the card,
    and an entry of the block's :class:`Recorder`.  While tracing is off,
    entering one costs a check of a module-level flag and nothing else;
  * :class:`SpanPlan`, the device spans of one V-cycle: a span opened with
    ``device=True`` while a plan is active also launches a marker kernel
    (``csrc/mark.cu``) at its entry and exit, which stamps the device's
    clock into the plan's buffer, so that a V-cycle replayed from a CUDA
    graph is split into its levels and phases on the device clock;
  * :func:`trace`, a ``torch.profiler`` trace, tracing on, written as a
    Chrome trace;
  * :func:`measure_op`, a timing that the asynchronous launch queue cannot
    fool: the slope of wall time between two iteration counts, each run
    ending in a one-element read to the host;
  * :class:`SolverLog`, rank-0 style structured records.

The port places its spans in ``solvers/cg.py`` (``pmg.cg.solve`` around a
solve, ``pmg.cg.host_read`` around each read to the host) and
``solvers/vcycle.py`` (``vcycle``, ``vcycle.io``, ``vcycle.L<l>.pre``,
``.restrict``, ``.prolongate``, ``.post`` and ``vcycle.coarse``, all
device spans), and one counter, :func:`count`, of the operator kernels'
passes: ``ops/cuda_laplace.py`` counts one for each pass of B.1 and B.4
(``pmg.laplace<dim>d.<mode>.p<degree>.n<cells>``) and
``ops/cuda_elasticity.py`` one for each pass of B.5
(``pmg.elasticity.<mode>/<core>.n<cells>``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import time
from typing import Callable, NamedTuple

import torch

from .. import _build

SOLVE = "pmg.cg.solve"  # a CG solve; its count numbers the solves
MARKER_KERNEL = "pmg_span_marker"  # the marker's name in a device trace
CAPACITY = 512  # marker slots of a plan's buffer
LAUNCHES = {"mark": 0}

_ACTIVE: Recorder | None = None  # the recorder of the innermost tracing()


@dataclasses.dataclass
class Span:
    """One span as the :class:`Recorder` keeps it: host clock in ns
    (``time.perf_counter_ns``); ``parent`` is the index of the enclosing
    span in ``Recorder.spans``; ``solve`` the id of the CG solve it lies in
    (the count of ``pmg.cg.solve`` spans before it); ``level`` the V-cycle
    level of a level's span."""

    name: str
    start_ns: int
    end_ns: int | None = None
    parent: int | None = None
    solve: int | None = None
    level: int | None = None


@dataclasses.dataclass
class PlannedSpan:
    """A device span of a :class:`SpanPlan`: its marker slots at entry and
    exit, and ``parent``, the index of the enclosing span in the plan."""

    name: str
    level: int | None
    parent: int | None
    enter: int
    exit: int | None = None


class SpanTime(NamedTuple):
    ms: float  # device ms per replay
    self_ms: float  # the part no child span covers


class SpanPlan:
    """The device spans of one V-cycle, in the order their markers launch.

    Where the V-cycle's vectors are one CUDA tensor, the plan owns an
    int64 [2, CAPACITY] buffer on its device (``csrc/mark.cu``: row 0 the
    stamps, row 1 the sums, slot 0's sum counting replays), and each span's
    entry and exit launches a marker on the current stream; elsewhere (the
    CPU, the sharded models' ``ShardedField``) it records the plan alone.
    The k-th marker of a run of the V-cycle is slot k of the plan.  A
    graph's plan is made before its capture, so the buffer lies outside
    the graph and its sums carry over from replay to replay."""

    def __init__(self, vector=None):
        self.spans: list[PlannedSpan] = []
        self.slots = 0
        # what :func:`count` counted while the plan was active: one run of
        # the V-cycle's (a graph's: its capture's, so each replay's)
        self.counts: collections.Counter = collections.Counter()
        self._open: list[int] = []
        self.buffer = None
        if isinstance(vector, torch.Tensor) and vector.is_cuda:
            self.buffer = torch.zeros((2, CAPACITY), dtype=torch.int64,
                                      device=vector.device)

    def enter(self, name: str, level: int | None) -> None:
        parent = self._open[-1] if self._open else None
        self._open.append(len(self.spans))
        self.spans.append(PlannedSpan(name, level, parent, self._mark()))

    def exit(self) -> None:
        self.spans[self._open.pop()].exit = self._mark()

    def _mark(self) -> int:
        slot = self.slots
        if slot >= CAPACITY:
            raise ValueError(f"a span plan holds at most {CAPACITY} markers")
        self.slots += 1
        if self.buffer is not None:
            lib = _build.build()
            err = lib.fn("pmg_mark")(self.buffer.data_ptr(), CAPACITY, slot,
                                     _build.stream_handle(self.buffer.device))
            if err:
                raise RuntimeError(f"span marker launch failed: CUDA error "
                                   f"{err}")
            LAUNCHES["mark"] += 1
        return slot

    def times(self, sums) -> dict[str, SpanTime]:
        """Device ms per replay of each span name (spans of one name
        summed) from the buffer's row of sums: a span's time is the sum of
        the intervals of the slots after its entry up to its exit, over the
        replays that slot 0 counted; its self time leaves out its children.
        Empty before any replay."""
        replays = int(sums[0])
        if not replays:
            return {}
        ms = [sum(int(v) for v in sums[s.enter + 1: s.exit + 1])
              / replays / 1e6 for s in self.spans]
        own = list(ms)
        for s, t in zip(self.spans, ms):
            if s.parent is not None:
                own[s.parent] -= t
        out: dict[str, SpanTime] = {}
        for s, t, o in zip(self.spans, ms, own):
            prev = out.get(s.name, SpanTime(0.0, 0.0))
            out[s.name] = SpanTime(prev.ms + t, prev.self_ms + o)
        return out


class Recorder:
    """What one :func:`tracing` block recorded: ``spans`` in the order they
    opened, ``counts`` of spans by name and of :func:`count`'s keys, and
    ``plans``, the :class:`SpanPlan` of each V-cycle run in the block (a
    graphed V-cycle's at its capture).  Read it when the block has ended."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counts: collections.Counter = collections.Counter()
        self.plans: list[SpanPlan] = []
        self.plan: SpanPlan | None = None  # the active plan
        self._open: list[tuple] = []  # (index, profiler range, nvtx)

    def open(self, scope: named_scope) -> None:
        name = scope.name
        parent = self._open[-1][0] if self._open else None
        self.counts[name] += 1
        solve = (self.counts[name] - 1 if name == SOLVE else
                 None if parent is None else self.spans[parent].solve)
        self._open.append((len(self.spans),
                           torch.profiler.record_function(name).__enter__(),
                           _nvtx_push(name)))
        self.spans.append(Span(name, time.perf_counter_ns(), parent=parent,
                               solve=solve, level=scope.level))
        if scope.device and self.plan is not None:
            self.plan.enter(name, scope.level)

    def close(self, scope: named_scope) -> None:
        index, prof_range, nvtx = self._open.pop()
        if scope.device and self.plan is not None:
            self.plan.exit()
        self.spans[index].end_ns = time.perf_counter_ns()
        if nvtx:
            torch.cuda.nvtx.range_pop()
        prof_range.__exit__(None, None, None)


def _nvtx_push(name: str) -> bool:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.nvtx.range_push(name)
        return True
    return False


def count(key: str) -> None:
    """While tracing is on, add one to ``key`` in the recorder's counts and
    in the active plan's; nothing while it is off."""
    rec = _ACTIVE
    if rec is None:
        return
    rec.counts[key] += 1
    if rec.plan is not None:
        rec.plan.counts[key] += 1


def active() -> Recorder | None:
    """The recorder of the innermost :func:`tracing` block, or None while
    tracing is off."""
    return _ACTIVE


@contextlib.contextmanager
def tracing():
    """Turn spans on for the block; yields its :class:`Recorder`."""
    global _ACTIVE
    outer, _ACTIVE = _ACTIVE, Recorder()
    try:
        yield _ACTIVE
    finally:
        _ACTIVE = outer


@contextlib.contextmanager
def planned(plan: SpanPlan):
    """Make ``plan`` the plan that device spans mark into, for the block;
    tracing is on."""
    rec = _ACTIVE
    outer, rec.plan = rec.plan, plan
    rec.plans.append(plan)
    try:
        yield plan
    finally:
        rec.plan = outer


class named_scope(contextlib.ContextDecorator):
    """``with named_scope("vcycle"):`` or ``@named_scope("vcycle")``: while
    :func:`tracing` is on, a ``torch.profiler.record_function`` range, where
    CUDA is in use in this process also a ``torch.cuda.nvtx`` range of the
    same name (the JAX package's ``jax.named_scope``), and an entry of the
    block's :class:`Recorder`; while it is off, nothing.  ``device=True``
    makes it a device span of the active :class:`SpanPlan`; ``level`` is a
    V-cycle level.  A scope keeps no state of its own, so one object may be
    entered again, nested or later."""

    def __init__(self, name: str, level: int | None = None,
                 device: bool = False):
        self.name = name
        self.level = level
        self.device = device

    def _recreate_cm(self):
        return self

    def __enter__(self):
        if _ACTIVE is not None:
            _ACTIVE.open(self)
        return self

    def __exit__(self, *exc):
        if _ACTIVE is not None:
            _ACTIVE.close(self)
        return False


@contextlib.contextmanager
def trace(dirname: str):
    """Profile the block with tracing on (CPU activity, and the card's
    where there is one) and write a Chrome trace, ``trace_<ns>.json``, into
    ``dirname`` (open it with Perfetto or chrome://tracing).  Yields the
    ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        with tracing():
            yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(dirname, f"trace_{time.time_ns()}.json"))


def measure_op(f: Callable, x0: torch.Tensor, iterations=(2, 8),
               params=None, repeats: int = 1,
               progress: Callable | None = None) -> float:
    """Seconds per iteration of x -> f(x) (or f(params, x) with
    ``params``), robust to asynchronous launches.

    Each timed run iterates f n times from ``x0`` and ends in a read of one
    element to the host, which waits for the device; the result is the
    slope between the two iteration counts, so the fixed cost of a run
    (launch queue, the read) drops out.  Every count runs once untimed
    first.  ``repeats`` > 1 keeps the best of several timed runs per count
    (the noise of a shared host is one-sided).  ``progress(slope_so_far,
    k)``, when given, is called after each round (both counts timed k
    times, in turns); a truthy return stops further rounds."""
    def run(n: int) -> float:
        y = x0
        for _ in range(n):
            y = f(y) if params is None else f(params, y)
        return float(y.reshape(-1)[:1].sum())

    for n in iterations:
        run(n)  # warm-up
    n0, n1 = iterations
    best = dict.fromkeys(iterations)
    slope = None
    for k in range(max(1, repeats)):
        for n in iterations:
            t0 = time.perf_counter()
            run(n)
            dt = time.perf_counter() - t0
            best[n] = dt if best[n] is None else min(best[n], dt)
        slope = (best[n1] - best[n0]) / (n1 - n0)
        if progress is not None and progress(slope, k + 1):
            break
    return slope


class SolverLog:
    """Rank-0-style structured logging (the ConditionalOStream analog,
    reference: source/geometric_multigrid/program.cc:118,132): each
    :meth:`log` keeps its fields and prints them as ``key=value`` pairs or
    as one JSON line."""

    def __init__(self, enabled: bool = True, json_lines: bool = False):
        self.enabled = enabled
        self.json_lines = json_lines
        self.records: list[dict] = []

    def log(self, **fields):
        self.records.append(fields)
        if not self.enabled:
            return
        if self.json_lines:
            print(json.dumps(fields))
        else:
            print(" ".join(f"{k}={v}" for k, v in fields.items()))
