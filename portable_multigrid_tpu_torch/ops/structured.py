"""Structured-grid gather/scatter primitives in torch.

Counterpart of ``portable_multigrid_tpu/ops/structured.py``.  On a
structured mesh the continuous Q_p DoFs form a tensor grid, so extracting
per-cell windows is a reshape plus one strided slice per axis and the
transposed "assembly" is an overlap-add — no indexed scatter, no atomics,
deterministic by construction.  All windows have width stride + 1.
"""

from __future__ import annotations

import torch


def exact_matmuls() -> None:
    """Keep float32 contractions on the card in full float32: TF32 keeps
    about three decimal digits, far below what CG and the golden counts
    need.  Called before every plain torch contraction on a CUDA tensor."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def split_windows(u: torch.Tensor, axis: int, n: int, stride: int) -> torch.Tensor:
    """Grid axis of length n*stride+1 -> overlapping windows [n, stride+1].

    The cell axis replaces ``axis``; the window axis is inserted at
    ``axis+1`` (adjacent windows share exactly one point)."""
    s = stride
    u = torch.movedim(u, axis, 0)
    body = u[: n * s].reshape((n, s) + tuple(u.shape[1:]))
    last = u[s::s][:, None]
    w = torch.cat([body, last], dim=1)  # [n, s+1, ...]
    return torch.movedim(w, (0, 1), (axis, axis + 1))


def overlap_add(v: torch.Tensor, axis: int, n: int, stride: int) -> torch.Tensor:
    """Transpose of :func:`split_windows`: out[i*s + j] += v[i, j]."""
    s = stride
    v = torch.movedim(v, (axis, axis + 1), (0, 1))  # [n, s+1, ...]
    rest = tuple(v.shape[2:])
    out = v.new_zeros((n * s + 1,) + rest)
    out[: n * s] = v[:, :s].reshape((n * s,) + rest)
    # each window's last point lands on the next window's first point
    out[s::s] += v[:, s]
    return torch.movedim(out, 0, axis)


def contract(t: torch.Tensor, M: torch.Tensor, axis: int) -> torch.Tensor:
    """Apply the 1D matrix M[out, in] along ``axis`` of t."""
    if t.is_cuda:
        exact_matmuls()
    out = torch.tensordot(t, M, dims=([axis], [1]))
    return torch.movedim(out, -1, axis)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in full precision on the card."""
    if a.is_cuda:
        exact_matmuls()
    return torch.matmul(a, b)


def split_all(u: torch.Tensor, dim: int, n: tuple, stride: int) -> torch.Tensor:
    """Split every grid axis: [n_d*s+1]*dim -> interleaved [n_d, s+1] layout.

    Cell axes land at even positions (0, 2, 4), DoF axes at odd ones
    (1, 3, 5)."""
    for d in range(dim):
        u = split_windows(u, 2 * d, n[d], stride)
    return u


def overlap_add_all(v: torch.Tensor, dim: int, n: tuple,
                    stride: int) -> torch.Tensor:
    """Transpose of :func:`split_all` (shared points summed)."""
    for d in reversed(range(dim)):
        v = overlap_add(v, 2 * d, n[d], stride)
    return v
