"""V-cycle multigrid preconditioner (torch).

Counterpart of ``portable_multigrid_tpu/solvers/vcycle.py`` with the
algorithmic structure of ``Portable::VCycleMultigrid`` (reference:
include/multigrid/portable_v_cycle_multigrid.h:26-190):

  * vmult zero-initialises and recurses from the finest level (:79-94);
  * smooth(u, rhs) = u + Cheb(rhs - A u) (:96-126);
  * coarsest level: one smooth with the Chebyshev-as-solver smoother
    (:148-154);
  * otherwise pre-smooth, residual, restrict, recurse, prolongate_and_add,
    post-smooth (:156-188).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.transfer import TrimmedTransfer, pad_last_planes, trim_last_planes


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
    kernel to kernel."""

    levels: tuple = ()
    pre_smoothing_steps: int = 2
    post_smoothing_steps: int = 2
    fine_trimmed: bool = False

    def _smooth(self, level: int, u: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
        lvl = self.levels[level]
        if hasattr(lvl.smoother, "smooth"):
            return lvl.smoother.smooth(u, rhs)
        r = rhs - lvl.op.apply(u)
        return u + lvl.smoother.apply(r)

    def _cycle(self, level: int, src: torch.Tensor) -> torch.Tensor:
        lvl = self.levels[level]
        if level == 0:
            # coarse "solve" = one Chebyshev-as-solver smooth from zero
            return lvl.smoother.apply(src)
        # the first pre-smooth acts on the zero initial guess: r = src, so
        # the residual apply is skipped (exact)
        u = lvl.smoother.apply(src)
        for _ in range(self.pre_smoothing_steps - 1):
            u = self._smooth(level, u, src)
        if hasattr(lvl.smoother, "residual"):
            residual = lvl.smoother.residual(u, src)
        else:
            residual = src - lvl.op.apply(u)
        coarse_residual = lvl.transfer.restrict(residual)
        coarse_correction = self._cycle(level - 1, coarse_residual)
        u = lvl.transfer.prolongate_and_add(u, coarse_correction)
        for _ in range(self.post_smoothing_steps):
            u = self._smooth(level, u, src)
        return u

    def apply(self, src: torch.Tensor) -> torch.Tensor:
        """Preconditioner vmult: dst = V-cycle(0, src) from the finest level."""
        top = len(self.levels) - 1
        if not self.fine_trimmed:
            return self._cycle(top, src)
        op = self.levels[-1].op
        st = trim_last_planes(src.reshape(op.shape), op.dim).contiguous()
        return pad_last_planes(self._cycle(top, st), op.dim)


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
