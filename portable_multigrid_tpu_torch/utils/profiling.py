"""Tracing and profiling helpers.

Counterpart of ``portable_multigrid_tpu/utils/profiling.py``.  The
reference's only observability hook is readable kernel names in
nvprof/Kokkos-Tools (reference:
include/operators/portable_laplace_operator.h:604, :797;
include/multigrid/portable_geometric_transfer.h:804).  Here:

  * :class:`named_scope`, a named range in ``torch.profiler`` traces and,
    in a process that uses the card, an NVTX range;
  * :func:`trace`, a ``torch.profiler`` trace written as a Chrome trace;
  * :func:`measure_op`, a timing that the asynchronous launch queue cannot
    fool: the slope of wall time between two iteration counts, each run
    ending in a one-element read to the host;
  * :class:`SolverLog`, rank-0 style structured records.

As in the JAX package, the port's own modules place no named scope.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable

import torch


class named_scope(contextlib.ContextDecorator):
    """``with named_scope("vcycle"):`` or ``@named_scope("vcycle")``: a
    ``torch.profiler.record_function`` range, and where CUDA is in use in
    this process also a ``torch.cuda.nvtx`` range of the same name (the
    JAX package's ``jax.named_scope``)."""

    def __init__(self, name: str):
        self.name = name
        self._stack = None

    def _recreate_cm(self):
        # a fresh range per decorated call, so that calls may nest
        return named_scope(self.name)

    def __enter__(self):
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(torch.profiler.record_function(self.name))
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self._stack.enter_context(torch.cuda.nvtx.range(self.name))
        return self

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)


@contextlib.contextmanager
def trace(dirname: str):
    """Profile the block (CPU activity, and the card's where there is one)
    and write a Chrome trace, ``trace_<ns>.json``, into ``dirname`` (open
    it with Perfetto or chrome://tracing).  Yields the
    ``torch.profiler.profile``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(dirname, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
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
