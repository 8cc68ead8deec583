"""One process's run of a cell: set-up, the timed window, the traced
window and the check of what the window produced.

The window is a closed loop with one client, as a time stepper or a
parameter sweep drives the solver: it builds the hierarchy once, then
solves A x = b_k for one right-hand side after another (``traffic.py``),
each through the program's entry,
``portable_multigrid_tpu_torch.solvers.cg.cg(model.fine_operator.apply,
b_k, model.preconditioner().apply, rtol=...)``, and waits for each answer.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import random
import time

import torch

from . import traffic as traffic_mod
from .spec import Cell

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}
TRACE_SPANS = ("cg.operator", "cg.preconditioner")


def synchronize(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_model(spec: dict, device):
    """The program's model class named by ``spec["class"]``, built from
    ``spec["kwargs"]`` (a key ending in ``dtype`` names a torch dtype)."""
    import portable_multigrid_tpu_torch as port

    kwargs = {k: DTYPES[v] if k.endswith("dtype") else v
              for k, v in spec["kwargs"].items()}
    return getattr(port, spec["class"])(device=device, **kwargs)


@dataclasses.dataclass
class Window:
    seconds: float  # wall time from the first solve's start to the last's end
    solve_s: list  # each solve's wall time, RHS assembly excluded
    iterations: list  # each solve's CG count
    converged: list
    precond_s: list  # device seconds of each preconditioner call (traced)
    sample: dict  # solve index -> x, drawn from the seed (and the worst)
    stream: traffic_mod.SourceStream


@dataclasses.dataclass
class RunRecord:
    """What a metric's reader (``metrics/<name>.py``) reads of a run."""

    cell: Cell
    window: Window
    trace: object  # trace.TraceSummary of the traced solves, or None
    setup_s: float  # process start to the window's first solve
    hierarchy_build_s: float
    graph_capture_s: float | None
    n_dofs: int  # of the fine level, where CG runs


class Session:
    """The program built once for a cell on ``device``."""

    def __init__(self, cell: Cell, device):
        self.cell, self.device = cell, torch.device(device)
        t = cell.traffic
        self.rtol, self.max_iter = float(t["rtol"]), int(t["max_iter"])
        synchronize(self.device)
        start = time.perf_counter()
        self.model = build_model(cell.model_spec(), self.device)
        synchronize(self.device)
        self.hierarchy_build_s = time.perf_counter() - start
        self.precond = self.model.preconditioner()
        op = self.model.fine_operator
        self.A, self.M = op.apply, self.precond.apply
        self.n_dofs = op.n_dofs
        shape = traffic_mod.rhs_shape(cell.config)
        if math.prod(shape) != self.n_dofs:
            raise ValueError(
                f"configuration {cell.config['name']} (components "
                f"{cell.config.get('components', 1)}) gives right-hand sides "
                f"of shape {shape}, {math.prod(shape)} entries; "
                f"{cell.model_spec()['class']}'s fine operator has "
                f"{self.n_dofs} DoFs")
        self.dtype = self.model.io_dtype or self.model.dtype
        if self.dtype != DTYPES[t["cg_dtype"]]:
            raise ValueError(f"{cell.model_spec()['class']} runs CG in "
                             f"{self.dtype}, the traffic asks for "
                             f"{t['cg_dtype']}")

    def callables(self):
        """(operator, preconditioner) handed to CG."""
        return self.A, self.M

    def stream(self, seed: int) -> traffic_mod.SourceStream:
        return traffic_mod.SourceStream(self.cell.traffic, self.cell.config,
                                        self.dtype, self.device, seed)

    def solve(self, b, A=None, M=None):
        from portable_multigrid_tpu_torch.solvers.cg import cg

        A0, M0 = self.callables()
        return cg(A or A0, b, M or M0, rtol=self.rtol, max_iter=self.max_iter)

    def warm_up(self) -> None:
        """One solve of the reference program's f = 1: it captures the
        V-cycle's graph and warms every shape and kernel of the window."""
        self.solve(self.stream(0).constant_rhs())
        synchronize(self.device)

    def graph_capture_s(self):
        """Warm-up plus capture of the graphed V-cycle, or None when the
        preconditioner is no CUDA graph."""
        seconds = getattr(self.precond, "capture_seconds", None)
        if not seconds:
            return None
        return sum(sum(v) for v in seconds.values())

    def window(self, seed: int, seconds: float, time_precond: bool = False
               ) -> Window:
        """Solve one right-hand side after another for ``seconds``; keep
        the solutions of a sample of the solves for the check."""
        stream = self.stream(seed)
        A, M = self.callables()
        events = []
        if time_precond and self.device.type == "cuda":
            M0 = M

            def M(v):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                out = M0(v)
                e1.record()
                events.append((e0, e1))
                return out

        keep = Reservoir(seed, int(self.cell.traffic["sample"]))
        solve_s, iters, conv = [], [], []
        start = time.perf_counter()
        deadline = start + seconds
        while time.perf_counter() < deadline:
            b = stream.next_rhs()
            synchronize(self.device)
            t = time.perf_counter()
            res = self.solve(b, A, M)
            synchronize(self.device)
            solve_s.append(time.perf_counter() - t)
            iters.append(res.iterations)
            conv.append(res.converged)
            keep.offer(len(iters) - 1, res.x, res.iterations)
        total = time.perf_counter() - start
        synchronize(self.device)
        return Window(total, solve_s, iters, conv,
                      [a.elapsed_time(b) / 1e3 for a, b in events],
                      keep.kept(), stream)

    def traced(self, seed: int, solves: int):
        """``solves`` solves under ``torch.profiler``, the callables wrapped
        in the spans of ``TRACE_SPANS``; returns the trace's summary."""
        from torch.profiler import ProfilerActivity, profile, record_function

        from .trace import WINDOW, summarize

        A0, M0 = self.callables()

        def spanned(name, fn):
            def call(v):
                with record_function(name):
                    return fn(v)
            return call

        A, M = spanned(TRACE_SPANS[0], A0), spanned(TRACE_SPANS[1], M0)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        stream = self.stream(seed)
        # a first, discarded profile starts the profiler's device tracing
        with profile(activities=activities):
            self.solve(stream.constant_rhs(), A, M)
            synchronize(self.device)
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                for _ in range(solves):
                    with record_function("bench.rhs"):
                        b = stream.next_rhs()
                    self.solve(b, A, M)
                synchronize(self.device)
        return summarize(prof.profiler.kineto_results, TRACE_SPANS)

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.model, self.precond, self.A, self.M
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class Reservoir:
    """A uniform sample of ``size`` solves of the window, drawn from the
    seed as the solves come (reservoir sampling), and the solve with the
    most CG iterations beside it."""

    def __init__(self, seed: int, size: int):
        self.rng = random.Random(traffic_mod.seed_int(seed))
        self.size = size
        self.items = {}
        self.worst = (-1, None, None)  # (iterations, index, x)

    def offer(self, k: int, x, iterations: int) -> None:
        if len(self.items) < self.size:
            self.items[k] = x
        else:
            j = self.rng.randrange(k + 1)
            if j < self.size:
                del self.items[sorted(self.items)[j]]
                self.items[k] = x
        if iterations > self.worst[0]:
            self.worst = (iterations, k, x)

    def kept(self) -> dict:
        out = dict(self.items)
        if self.worst[1] is not None:
            out[self.worst[1]] = self.worst[2]
        return out

