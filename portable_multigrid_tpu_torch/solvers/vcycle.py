"""V-cycle multigrid preconditioner (torch).

Counterpart of ``portable_multigrid_tpu/solvers/vcycle.py`` with the
algorithmic structure of ``Portable::VCycleMultigrid`` (reference:
include/multigrid/portable_v_cycle_multigrid.h:26-190):

  * vmult zero-initialises and recurses from the finest level (:79-94);
  * smooth(u, rhs) = u + Cheb(rhs - A u) (:96-126);
  * coarsest level: one smooth with the Chebyshev-as-solver smoother
    (:148-154);
  * otherwise pre-smooth, residual, restrict, recurse, prolongate_and_add,
    post-smooth (:156-188); a smoother with ``smooth_and_residual`` runs
    the last pre-smoothing step and the residual as one call, as the JAX
    package's V-cycle does (its ``fuse_sr``).

On a CUDA device :class:`GraphedVCycle` replays the whole V-cycle from one
CUDA graph, the port's counterpart of the V-cycle traced into the JAX
package's jitted solve.

While :func:`~..utils.profiling.tracing` is on, the V-cycle opens device
spans (``utils/profiling.py``): ``vcycle`` around the whole cycle,
``vcycle.io`` around the fine trim and pad and the dtype casts, per level
``l`` (``levels[0]`` the coarsest) ``vcycle.L<l>.pre`` (the pre-smoothing
steps with the residual), ``.restrict``, ``.prolongate`` (with
``TrimmedTransfer``'s pads and trims) and ``.post``, and ``vcycle.coarse``.
A graph captured while tracing is on is a graph of its own that holds their
markers; :meth:`GraphedVCycle.span_ms` reads its split.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from ..ops.transfer import TrimmedTransfer, pad_last_planes, trim_last_planes
from ..utils import profiling

_OFF = contextlib.nullcontext()
_VCYCLE = profiling.named_scope("vcycle", device=True)
_IO = profiling.named_scope("vcycle.io", device=True)


@dataclasses.dataclass
class MGLevel:
    """One level: operator, smoother, and the transfer to/from the next
    coarser level (None on the coarsest)."""

    op: object = None
    smoother: object = None
    transfer: object = None


@dataclasses.dataclass
class VCycle:
    """Multigrid V-cycle preconditioner; ``levels[0]`` is the coarsest.

    ``fine_trimmed=True`` (from :func:`wire_trimmed`) means the finest
    level runs on trimmed state: :meth:`apply` trims the incoming full-grid
    residual once and pads the result once, and everything in between chains
    kernel to kernel.  ``io_dtype`` (mixed precision) is the dtype of the
    caller's vectors where it differs from the levels': :meth:`apply` casts
    its input to the levels' dtype and its result back."""

    levels: tuple = ()
    pre_smoothing_steps: int = 2
    post_smoothing_steps: int = 2
    fine_trimmed: bool = False
    io_dtype: torch.dtype | None = None

    def _smooth(self, level: int, u: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
        lvl = self.levels[level]
        if hasattr(lvl.smoother, "smooth"):
            return lvl.smoother.smooth(u, rhs)
        r = rhs - lvl.op.apply(u)
        return u + lvl.smoother.apply(r)

    @staticmethod
    def _span(phase: str, level: int):
        """The device span of ``phase`` on ``level`` while tracing is on, a
        shared no-op otherwise."""
        if profiling.active() is None:
            return _OFF
        name = "vcycle.coarse" if level == 0 else f"vcycle.L{level}.{phase}"
        return profiling.named_scope(name, level, device=True)

    def _cycle(self, level: int, src: torch.Tensor) -> torch.Tensor:
        lvl = self.levels[level]
        if level == 0:
            # coarse "solve" = one Chebyshev-as-solver smooth from zero
            with self._span("coarse", 0):
                return lvl.smoother.apply(src)
        with self._span("pre", level):
            # the first pre-smooth acts on the zero initial guess: r = src,
            # so the residual apply is skipped (exact)
            u = lvl.smoother.apply(src)
            # the last pre-smooth and the residual in one call where the
            # smoother fuses them (B.2's cheb2lr), as smooth then residual
            fuse_sr = (self.pre_smoothing_steps >= 2
                       and hasattr(lvl.smoother, "smooth_and_residual"))
            for _ in range(self.pre_smoothing_steps - (2 if fuse_sr else 1)):
                u = self._smooth(level, u, src)
            if fuse_sr:
                u, residual = lvl.smoother.smooth_and_residual(u, src)
            elif hasattr(lvl.smoother, "residual"):
                residual = lvl.smoother.residual(u, src)
            else:
                residual = src - lvl.op.apply(u)
        with self._span("restrict", level):
            coarse_residual = lvl.transfer.restrict(residual)
        coarse_correction = self._cycle(level - 1, coarse_residual)
        with self._span("prolongate", level):
            u = lvl.transfer.prolongate_and_add(u, coarse_correction)
        with self._span("post", level):
            for _ in range(self.post_smoothing_steps):
                u = self._smooth(level, u, src)
        return u

    def apply(self, src: torch.Tensor,
              plan: profiling.SpanPlan | None = None) -> torch.Tensor:
        """Preconditioner vmult: dst = V-cycle(0, src) from the finest level.

        While tracing is on, the cycle's device spans go into ``plan``, or
        into a plan of this call's own (:class:`GraphedVCycle` passes the
        plan of the graph it captures)."""
        if profiling.active() is None:
            return self._apply(src)
        with profiling.planned(plan or profiling.SpanPlan(src)), _VCYCLE:
            return self._apply(src)

    def _apply(self, src: torch.Tensor) -> torch.Tensor:
        """The cycle from the finest level, between the casts of
        ``io_dtype`` and the trim and pad of a trimmed fine level."""
        top = len(self.levels) - 1
        if self.io_dtype is None and not self.fine_trimmed:
            return self._cycle(top, src)
        op = self.levels[-1].op
        with _IO:
            if self.io_dtype is not None:
                src = src.to(op.dtype)
            if self.fine_trimmed:
                src = trim_last_planes(src.reshape(op.shape),
                                       op.dim).contiguous()
        out = self._cycle(top, src)
        with _IO:
            if self.fine_trimmed:
                out = pad_last_planes(out, op.dim)
            if self.io_dtype is not None:
                out = out.to(self.io_dtype)
        return out


class GraphedVCycle:
    """A :class:`VCycle` on a CUDA device, replayed from one CUDA graph per
    input (shape, dtype).

    The first :meth:`apply` for a (shape, dtype) runs one eager V-cycle on a
    side stream (the warm-up: every kernel instance loads and the allocator
    fills), captures ``vcycle.apply`` on a static input into a
    ``torch.cuda.CUDAGraph``, and replays it.  Every call copies its source
    into the static input, replays, and returns a copy of the static output,
    which the next replay overwrites.  The kernels launch on the current
    stream, which under capture is the capture stream; a wrapper's launch
    count rises at the warm-up and at capture, never at a replay.  A failed
    capture or replay raises: nothing runs eagerly in its place.  CPU
    tensors are refused; on the CPU the models run the :class:`VCycle`
    itself.

    While :func:`~..utils.profiling.tracing` is on, a call replays a graph
    of its own, captured with the V-cycle's span markers
    (:class:`~..utils.profiling.SpanPlan`); the graph replayed while tracing
    is off holds no marker."""

    def __init__(self, vcycle: VCycle):
        self.vcycle = vcycle
        self._graphs = {}
        # seconds of the warm-up and of capture plus instantiation, by key
        self.capture_seconds = {}
        # the plan of the traced graph replayed last
        self.span_plan: profiling.SpanPlan | None = None

    def apply(self, src: torch.Tensor) -> torch.Tensor:
        if not src.is_cuda:
            raise ValueError(f"GraphedVCycle replays on a CUDA device, not "
                             f"{src.device}; run the VCycle itself there")
        traced = profiling.active() is not None
        key = (tuple(src.shape), src.dtype, src.device, traced)
        if key not in self._graphs:
            self._graphs[key] = self._capture(src, key, traced)
        graph, static_in, static_out, plan = self._graphs[key]
        if plan is not None:
            self.span_plan = plan
        static_in.copy_(src)
        graph.replay()
        return static_out.clone()

    def span_ms(self) -> dict[str, profiling.SpanTime]:
        """Device ms per replay of each span of the traced graph replayed
        last, and its self time (``SpanPlan.times``), over the replays
        since the previous call: one copy of the plan's sums to the host,
        then the sums start again from zero.  Empty where no traced graph
        was replayed."""
        plan = self.span_plan
        if plan is None:
            return {}
        sums = plan.buffer[1]
        out = plan.times(sums.tolist())
        sums.zero_()
        return out

    def _capture(self, src: torch.Tensor, key, traced: bool) -> tuple:
        static_in = src.clone()
        current = torch.cuda.current_stream(src.device)
        side = torch.cuda.Stream(src.device)
        t0 = time.perf_counter()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.vcycle.apply(static_in)
        current.wait_stream(side)
        torch.cuda.synchronize(src.device)
        t1 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        # the plan's buffer is made here, outside the graph
        plan = profiling.SpanPlan(static_in) if traced else None
        with torch.cuda.device(src.device), torch.cuda.graph(graph):
            if plan is None:
                static_out = self.vcycle.apply(static_in)
            else:
                static_out = self.vcycle.apply(static_in, plan)
        self.capture_seconds[key] = (t1 - t0, time.perf_counter() - t1)
        return graph, static_in, static_out, plan


def wire_trimmed(levels):
    """Wrap plain transfers between levels of different representation in
    :class:`~..ops.transfer.TrimmedTransfer`; returns ``(levels,
    fine_trimmed)``.  Transfers that already speak trimmed state (they have
    a ``coarse_trimmed`` flag) are left alone."""
    wired = []
    prev_trim = False
    for lvl in levels:
        trim = bool(getattr(lvl.smoother, "trimmed_io", False))
        tr = lvl.transfer
        if (tr is not None and (trim or prev_trim)
                and not hasattr(tr, "coarse_trimmed")):
            tr = TrimmedTransfer(fine_trimmed=trim, coarse_trimmed=prev_trim,
                                 base=tr)
        wired.append(MGLevel(op=lvl.op, smoother=lvl.smoother, transfer=tr))
        prev_trim = trim
    return wired, prev_trim
