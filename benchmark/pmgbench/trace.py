"""What the benchmark reads from a ``torch.profiler`` trace.

The traced solves run inside a host span ``bench.window``; the benchmark
wraps the callables it hands to CG in the spans ``cg.operator`` and
``cg.preconditioner``.  From the profiler's raw events this module takes:

  * each card's busy time: the union of that card's kernel, copy and set
    intervals that fall inside the window (overlap counted once); the
    device's busy time, the mean over the cell's cards (one card's union
    on a one-card cell); and the window's length;
  * the device time of each span: the kernels and copies whose launching
    host call lies inside one of the span's intervals (the profiler gives
    a device event the correlation id of the runtime or driver call that
    launched it), summed, and the number of the span's intervals;
  * the device operations that took the most time, by name, summed over
    the cards, and the idle gaps between the device intervals of the least
    busy card, each named after the innermost host event of the main thread
    at the gap's start (what the host was doing while the card waited),
    summed by name.

A device event's card is its ``device_index()``; events of cards outside
the cell's are left out.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

WINDOW = "bench.window"
TOP = 10


def _is_device_work(ev) -> bool:
    """A device event that is a kernel, copy or set, not an annotation of
    the device's timeline (older torch has no ``activity_type``)."""
    if hasattr(ev, "activity_type"):
        kind = str(ev.activity_type()).lower()
        return any(k in kind for k in ("kernel", "memcpy", "memset"))
    return not ev.is_user_annotation()


def _end(ev) -> int:
    return ev.start_ns() + ev.duration_ns()


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float  # the mean of busy_s_per_card
    busy_s_per_card: list  # each card's busy seconds, in the cell's order
    span_device_s: dict  # span name -> summed device seconds
    span_count: dict  # span name -> intervals of the span
    device_ops: list  # [[name, seconds], ...], most first
    idle_gaps: list  # [[host activity, seconds], ...], most first


def _union(intervals) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _label_gaps(gaps, host) -> dict:
    """Seconds of idle gap by the innermost host event open at each gap's
    start; ``host`` holds (start, end, name) of one thread's events, which
    nest."""
    out = collections.Counter()
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    stack, i = [], 0
    for g0, g1 in sorted(gaps):
        while i < len(host) and host[i][0] <= g0:
            while stack and stack[-1][1] < host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < g0:
            stack.pop()
        out[stack[-1][2] if stack else "(no host event)"] += (g1 - g0) / 1e9
    return out


def summarize(kineto_results, spans=("cg.operator", "cg.preconditioner"),
              *, cards: list) -> TraceSummary:
    """Reduce ``prof.profiler.kineto_results`` of one traced window;
    ``cards``: the indices of the cell's cards."""
    events = kineto_results.events()
    host = [ev for ev in events
            if "cuda" not in str(ev.device_type()).lower()]
    device = [ev for ev in events
              if "cuda" in str(ev.device_type()).lower()
              and _is_device_work(ev) and ev.device_index() in cards]
    windows = [ev for ev in host if ev.name() == WINDOW]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} {WINDOW} spans")
    w0, w1 = windows[0].start_ns(), _end(windows[0])
    main = windows[0].start_thread_id()
    inside = [ev for ev in device
              if _end(ev) > w0 and ev.start_ns() < w1]
    busy = {c: _union((max(ev.start_ns(), w0), min(_end(ev), w1))
                      for ev in inside if ev.device_index() == c)
            for c in cards}
    busy_ns = [sum(e - s for s, e in busy[c]) for c in cards]

    by_name = collections.Counter()
    for ev in inside:
        by_name[ev.name()] += ev.duration_ns() / 1e9

    # device seconds of each span, through the host call that launched the
    # device event: the runtime or driver call of the same correlation id
    # (a kernel of this program's library, a graph replay's kernels), else
    # the operator the profiler links it to
    span_ivals = {s: sorted((ev.start_ns(), _end(ev)) for ev in host
                            if ev.name() == s) for s in spans}
    starts = {s: [a for a, _ in v] for s, v in span_ivals.items()}
    api = {ev.correlation_id(): ev.start_ns() for ev in host
           if ev.name().startswith("cu") and ev.correlation_id()}
    ops = {ev.correlation_id(): ev.start_ns() for ev in host
           if not ev.name().startswith("cu") and ev.correlation_id()}
    span_s = dict.fromkeys(spans, 0.0)
    for ev in device:
        t = api.get(ev.correlation_id(), ops.get(ev.linked_correlation_id()))
        if t is None:
            continue
        for s, ivals in span_ivals.items():
            k = bisect.bisect_right(starts[s], t) - 1
            if k >= 0 and t <= ivals[k][1]:
                span_s[s] += ev.duration_ns() / 1e9

    # the idle gaps of the least busy card (a card with no work in the
    # window idles through all of it)
    gaps = []
    if cards:
        least = busy[cards[busy_ns.index(min(busy_ns))]] or [[w0, w0]]
        gaps = ([(w0, least[0][0])]
                + [(a[1], b[0]) for a, b in zip(least, least[1:])]
                + [(least[-1][1], w1)])
    main_host = [(ev.start_ns(), _end(ev), ev.name()) for ev in host
                 if ev.start_thread_id() == main and ev.name() != WINDOW]
    idle = _label_gaps([g for g in gaps if g[1] > g[0]], main_host)
    per_card = [ns / 1e9 for ns in busy_ns]
    return TraceSummary(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(per_card) / len(per_card) if per_card else 0.0,
        busy_s_per_card=per_card, span_device_s=span_s,
        span_count={s: len(v) for s, v in span_ivals.items()},
        device_ops=[[n, s] for n, s in by_name.most_common(TOP)],
        idle_gaps=[[n, s] for n, s in idle.most_common(TOP)])
