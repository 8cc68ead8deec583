"""One process's run of a cell: set-up, the timed window, the traced
window and the check of what the window produced.

The window is a closed loop with one client, as a time stepper or a
parameter sweep drives the solver: it builds the hierarchy once, then
solves A x = b_k for one right-hand side after another (``traffic.py``),
each through the program's entry,
``portable_multigrid_tpu_torch.solvers.cg.cg(model.fine_operator.apply,
b_k, model.preconditioner().apply, rtol=...)``, and waits for each answer.

A cell on S > 1 cards (``spec.py``) builds its model on cards 0..S-1 (on
the CPU S times the CPU), hands CG the model's ``dot`` and each b_k as the
program's sharded field of the stream's slabs, synchronises every card
around each solve, and keeps each sampled x as its slabs, on their cards.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import random
import time

import torch

from . import slabs
from . import traffic as traffic_mod
from .spec import Cell

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}
TRACE_SPANS = ("cg.operator", "cg.preconditioner")
PROGRAM = "portable_multigrid_tpu_torch"


def cards(devices) -> list:
    """The distinct CUDA devices among ``devices``, in order."""
    return list(dict.fromkeys(d for d in devices if d.type == "cuda"))


def card_index(device) -> int:
    """The index of a CUDA device (``cuda`` alone: the current card)."""
    return torch.cuda.current_device() if device.index is None \
        else device.index


def synchronize(devices) -> None:
    """Wait for every CUDA card of ``devices`` (one device or a list)."""
    if isinstance(devices, torch.device):
        devices = [devices]
    for d in cards(devices):
        torch.cuda.synchronize(d)


def cell_devices(cell: Cell, device) -> list:
    """The devices of the cell's S cards: ``device`` itself for one card;
    for S > 1 cards 0..S-1 where ``device`` is CUDA, else S times
    ``device``; or ``device`` as given where it is a list of S."""
    if isinstance(device, (list, tuple)):
        devices = [torch.device(d) for d in device]
    else:
        d = torch.device(device)
        devices = ([d] if cell.chips == 1 else
                   [torch.device("cuda", k) for k in range(cell.chips)]
                   if d.type == "cuda" else [d] * cell.chips)
    if len(devices) != cell.chips:
        raise ValueError(f"cell {cell.name} takes {cell.chips} cards, "
                         f"given {len(devices)} devices")
    return devices


def program_class(name: str):
    """The program's class ``name``: a name of the package, or a dotted name
    under it, whose last part is a class of the module it names or of one
    of that package's modules (``parallel.ShardedGeometricPoisson``:
    ``parallel/poisson.py``'s)."""
    import importlib
    import pkgutil

    module, _, cls = name.rpartition(".")
    mod = importlib.import_module(PROGRAM + ("." + module if module else ""))
    if hasattr(mod, cls):
        return getattr(mod, cls)
    for info in pkgutil.iter_modules(getattr(mod, "__path__", [])):
        sub = importlib.import_module(f"{mod.__name__}.{info.name}")
        found = getattr(sub, cls, None)
        if found is not None and found.__module__ == sub.__name__:
            return found
    raise AttributeError(f"the program has no class {name!r} "
                         f"({PROGRAM}.{name})")


def build_model(spec: dict, devices: list):
    """The program's model class named by ``spec["class"]``
    (:func:`program_class`), built from ``spec["kwargs"]`` (a key ending in
    ``dtype`` names a torch dtype) on ``devices``: with ``device=`` on one,
    with ``devices=`` on several."""
    cls = program_class(spec["class"])
    kwargs = {k: DTYPES[v] if k.endswith("dtype") else v
              for k, v in spec["kwargs"].items()}
    if len(devices) == 1:
        return cls(device=devices[0], **kwargs)
    return cls(devices=devices, **kwargs)


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
    """The program built once for a cell on ``device`` (for S > 1 cards,
    :func:`cell_devices`)."""

    def __init__(self, cell: Cell, device):
        self.cell = cell
        self.devices = cell_devices(cell, device)
        self.device = self.devices[0]
        self.sharded = cell.chips > 1
        t = cell.traffic
        self.rtol, self.max_iter = float(t["rtol"]), int(t["max_iter"])
        if self.sharded and cell.config.get("components", 1) != 1:
            raise ValueError(f"configuration {cell.config['name']}: a cell "
                             f"on {cell.chips} cards takes scalar fields")
        synchronize(self.devices)
        start = time.perf_counter()
        self.model = build_model(cell.model_spec(), self.devices)
        synchronize(self.devices)
        self.hierarchy_build_s = time.perf_counter() - start
        self.precond = self.model.preconditioner()
        op = self.model.fine_operator
        self.A, self.M = op.apply, self.precond.apply
        shape = traffic_mod.rhs_shape(cell.config)
        if self.sharded:
            self.n_dofs = math.prod(shape)
            self.dot = self.model.dot
            self._check_slabs(op.inv_diag.parts)
        else:
            self.n_dofs = op.n_dofs
            self.dot = None
        if math.prod(shape) != self.n_dofs:
            raise ValueError(
                f"configuration {cell.config['name']} (components "
                f"{cell.config.get('components', 1)}) gives right-hand sides "
                f"of shape {shape}, {math.prod(shape)} entries; "
                f"{cell.model_spec()['class']}'s fine operator has "
                f"{self.n_dofs} DoFs")
        self.dtype = getattr(self.model, "io_dtype", None) or self.model.dtype
        if self.dtype != DTYPES[t["cg_dtype"]]:
            raise ValueError(f"{cell.model_spec()['class']} runs CG in "
                             f"{self.dtype}, the traffic asks for "
                             f"{t['cg_dtype']}")

    def _check_slabs(self, parts) -> None:
        """The model's slabs (of a fine-level field) against the harness's
        layout: one a card, on its card, of the layout's shape."""
        want = slabs.shapes(self.cell.config, self.cell.chips)
        got = [tuple(t.shape) for t in parts]
        where = [t.device for t in parts]
        if got != want or where != self.devices:
            raise ValueError(
                f"configuration {self.cell.config['name']} on S = "
                f"{self.cell.chips} cards: the model's slabs {got} on "
                f"{[str(d) for d in where]}, the harness's layout "
                f"{want} on {[str(d) for d in self.devices]}")

    def callables(self):
        """(operator, preconditioner) handed to CG."""
        return self.A, self.M

    def stream(self, seed: int) -> traffic_mod.SourceStream:
        return traffic_mod.SourceStream(
            self.cell.traffic, self.cell.config, self.dtype, self.device,
            seed, devices=self.devices if self.sharded else None)

    def solve(self, b, A=None, M=None):
        """CG on the right-hand side b (a multi-card cell's: its slabs)."""
        from portable_multigrid_tpu_torch.solvers.cg import cg

        A0, M0 = self.callables()
        if self.sharded:
            from portable_multigrid_tpu_torch.parallel.sharding import (
                ShardedField,
            )

            b = ShardedField(b)
        return cg(A or A0, b, M or M0, rtol=self.rtol, max_iter=self.max_iter,
                  dot=self.dot)

    def held(self, x):
        """A solution as the harness keeps it: a multi-card cell's as the
        list of its slabs."""
        return list(x.parts) if self.sharded else x

    def warm_up(self) -> None:
        """One solve of the reference program's f = 1: it captures the
        V-cycle's graph and warms every shape and kernel of the window."""
        self.solve(self.stream(0).constant_rhs())
        synchronize(self.devices)

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
        on = cards(self.devices)
        if time_precond and on:
            M0 = M

            def M(v):
                # a pair of events on each card; the call's time is the
                # longest card's
                pairs = [[torch.cuda.Event(enable_timing=True)
                          for _ in range(2)] for _ in on]
                for (e0, _), d in zip(pairs, on):
                    e0.record(torch.cuda.current_stream(d))
                out = M0(v)
                for (_, e1), d in zip(pairs, on):
                    e1.record(torch.cuda.current_stream(d))
                events.append(pairs)
                return out

        keep = Reservoir(seed, int(self.cell.traffic["sample"]))
        solve_s, iters, conv = [], [], []
        start = time.perf_counter()
        deadline = start + seconds
        while time.perf_counter() < deadline:
            b = stream.next_rhs()
            synchronize(self.devices)
            t = time.perf_counter()
            res = self.solve(b, A, M)
            synchronize(self.devices)
            solve_s.append(time.perf_counter() - t)
            iters.append(res.iterations)
            conv.append(res.converged)
            keep.offer(len(iters) - 1, self.held(res.x), res.iterations)
        total = time.perf_counter() - start
        synchronize(self.devices)
        return Window(total, solve_s, iters, conv,
                      [max(a.elapsed_time(b) for a, b in pairs) / 1e3
                       for pairs in events],
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
        on = cards(self.devices)
        if on:
            activities.append(ProfilerActivity.CUDA)
        stream = self.stream(seed)
        # a first, discarded profile starts the profiler's device tracing
        with profile(activities=activities):
            self.solve(stream.constant_rhs(), A, M)
            synchronize(self.devices)
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                for _ in range(solves):
                    with record_function("bench.rhs"):
                        b = stream.next_rhs()
                    self.solve(b, A, M)
                synchronize(self.devices)
        return summarize(prof.profiler.kineto_results, TRACE_SPANS,
                         cards=[card_index(d) for d in on])

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        del self.model, self.precond, self.A, self.M, self.dot
        gc.collect()
        if cards(self.devices):
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

