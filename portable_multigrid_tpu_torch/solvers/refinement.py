"""Mixed-precision iterative refinement: float64 accuracy from float32
inner solves (torch).

Counterpart of ``portable_multigrid_tpu/solvers/refinement.py``: classical
iterative refinement (Wilkinson; Carson & Higham 2018),

    x = 0;  r = b                                [float64]
    repeat: d = InnerSolve(r) to ~1e-7           [float32 CG + V-cycle]
            x += d;  r = b - A x                 [float64 operator apply]
    until ||r|| <= rtol ||b||

Each cycle multiplies the residual by about the inner tolerance, so two to
three float32 inner solves reach 1e-12.  The loop runs on the host with one
device-to-host read of ||r|| a cycle.
"""

from __future__ import annotations

from typing import Callable

import torch


def iterative_refinement(
    A64: Callable,
    inner_solve32: Callable,
    b: torch.Tensor,
    *,
    rtol: float = 1e-12,
    max_cycles: int = 8,
) -> tuple[torch.Tensor, int, float]:
    """Solve A x = b to float64 accuracy with a float32 inner solver.

    A64: float64 operator apply; inner_solve32: float32 tensor -> float32
    tensor (an approximate solve, e.g. CG + V-cycle to ~1e-7).  Returns
    (x, cycles, residual_norm)."""
    b = b.to(torch.float64)
    norm = lambda v: float(torch.linalg.vector_norm(v))
    threshold = rtol * norm(b)
    x = torch.zeros_like(b)
    r = b
    res = norm(b)
    cycles = 0
    while res > threshold and cycles < max_cycles:
        d = inner_solve32(r.to(torch.float32)).to(torch.float64)
        x = x + d
        r = b - A64(x)
        res = norm(r)  # the one host read of the cycle
        cycles += 1
    return x, cycles, res
