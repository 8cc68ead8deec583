"""Preconditioned conjugate gradients (torch, eager).

Counterpart of ``portable_multigrid_tpu/solvers/cg.py:cg`` — deal.II's
``SolverCG`` + ``SolverControl`` as the reference driver uses them
(reference: source/geometric_multigrid/program.cc:345-352: tolerance
rtol * ||b||, max_iter = vector size).  The loop runs on the host with one
device-to-host read per iteration, for the stopping test.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass
class CGResult:
    x: torch.Tensor
    iterations: int  # deal.II last_step semantics
    residual_norm: float
    converged: bool


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def cg(
    A: Callable,
    b: torch.Tensor,
    M: Callable | None = None,
    *,
    rtol: float = 1e-12,
    max_iter: int | None = None,
) -> CGResult:
    """Solve A x = b with preconditioned CG from x = 0.

    Stops when ||r||_2 <= rtol * ||b||_2, checked after each update, or
    after ``max_iter`` (default ``b.numel()``) iterations."""
    if M is None:
        M = lambda v: v
    if max_iter is None:
        max_iter = b.numel()
    norm = lambda v: torch.sqrt(_dot(v, v))
    x = torch.zeros_like(b)
    r = b
    threshold = float(rtol * norm(b))
    res = float(norm(r))
    z = M(r)
    rz = _dot(r, z)
    p = z
    it = 0
    while res > threshold and it < max_iter:
        Ap = A(p)
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        res_t = norm(r)
        z = M(r)
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
        res = float(res_t)  # the one host sync of the iteration
    return CGResult(x=x, iterations=it, residual_norm=res,
                    converged=res <= threshold)
