"""Preconditioned conjugate gradients (torch, eager).

Counterpart of ``portable_multigrid_tpu/solvers/cg.py:cg`` — deal.II's
``SolverCG`` + ``SolverControl`` as the reference driver uses them
(reference: source/geometric_multigrid/program.cc:345-352: tolerance
rtol * ||b||, max_iter = vector size).  The loop runs on the host with one
device-to-host read before it (the threshold and ||b|| in one transfer) and
one per iteration, for the stopping test.  While tracing is on
(``utils/profiling.py``) a solve is a ``pmg.cg.solve`` span and each read a
``pmg.cg.host_read`` span inside it.
:func:`cg_fixed_iterations` runs a fixed number of steps with no host read.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..utils import profiling

_SOLVE = profiling.named_scope(profiling.SOLVE)
_HOST_READ = profiling.named_scope("pmg.cg.host_read")


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
    dot: Callable | None = None,
) -> CGResult:
    """Solve A x = b with preconditioned CG from x = 0.

    Stops when ||r||_2 <= rtol * ||b||_2, checked after each update, or
    after ``max_iter`` (default ``b.numel()``) iterations.

    ``dot`` overrides the inner product, the norm included: the sharded
    solver passes its duplicate-plane-weighted dot summed over the shards
    (``parallel/sharding.py``), the counterpart of the MPI allreduce in
    deal.II's vector dots, as the JAX package's ``cg`` takes it."""
    if M is None:
        M = lambda v: v
    if max_iter is None:
        max_iter = b.numel()
    if dot is None:
        dot = _dot
    norm = lambda v: torch.sqrt(dot(v, v))
    with _SOLVE:
        x = torch.zeros_like(b)
        r = b
        norm_b = norm(b)
        # threshold and ||r|| = ||b|| in one read, in b's dtype
        with _HOST_READ:
            threshold, res = torch.stack((rtol * norm_b, norm_b)).tolist()
        z = M(r)
        rz = dot(r, z)
        # a copy: a graphed preconditioner's next call may reuse z's storage
        p = z.clone()
        it = 0
        while res > threshold and it < max_iter:
            Ap = A(p)
            alpha = rz / dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            res_t = norm(r)
            z = M(r)
            rz_new = dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
            it += 1
            with _HOST_READ:
                res = float(res_t)  # the one host sync of the iteration
    return CGResult(x=x, iterations=it, residual_norm=res,
                    converged=res <= threshold)


def cg_fixed_iterations(
    A: Callable,
    b: torch.Tensor,
    M: Callable | None = None,
    *,
    n_iter: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Run exactly ``n_iter`` preconditioned CG steps from x = 0; return
    (x, history), history the [n_iter] residual norms on b's device.

    Counterpart of ``portable_multigrid_tpu/solvers/cg.py:cg_fixed_iterations``:
    once a residual is exactly zero every later step is a no-op (alpha and
    beta zeroed), and the divisions are guarded, with no host read."""
    if M is None:
        M = lambda v: v
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    x = torch.zeros_like(b)
    r = b
    z = M(r)
    rz = _dot(r, z)
    p = z.clone()
    stop = torch.zeros((), dtype=torch.bool, device=b.device)
    history = []
    for _ in range(n_iter):
        Ap = A(p)
        pAp = _dot(p, Ap)
        alpha = torch.where(stop, zero, rz / torch.where(pAp == 0, one, pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        res = torch.sqrt(_dot(r, r))
        z = M(r)
        rz_new = _dot(r, z)
        beta = torch.where(stop, zero, rz_new / torch.where(rz == 0, one, rz))
        p = z + beta * p
        stop = stop | (res == 0)
        rz = rz_new
        history.append(res)
    if not history:
        return x, zero.new_zeros(0)
    return x, torch.stack(history)
