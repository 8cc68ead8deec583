"""The slab layout of a multi-card cell, the harness's own.

A cell on S > 1 cards holds a scalar field of the configuration's grid
(N points an axis) in S slabs along grid axis 0, slab s on card s: with
L = (N - 1) / S, slab s holds the grid planes [s L, (s + 1) L], so that
neighbouring slabs share one plane, each holding a copy.  The layout is
worked out from the configuration's ``dim``, ``degree`` and
``refinements`` and S alone; the program's own layout has to agree with
it (``session.Session`` checks the model's slabs in set-up).
"""

from __future__ import annotations

import torch

from . import fe1d


def bounds(config: dict, n_slabs: int) -> list[tuple[int, int]]:
    """[start, stop) of each slab's planes along grid axis 0."""
    n = fe1d.n_points(config["degree"], config["refinements"])
    if (n - 1) % n_slabs:
        raise ValueError(f"configuration {config.get('name')}: {n - 1} "
                         f"grid intervals along axis 0 do not split into "
                         f"{n_slabs} slabs")
    L = (n - 1) // n_slabs
    return [(s * L, (s + 1) * L + 1) for s in range(n_slabs)]


def shapes(config: dict, n_slabs: int) -> list[tuple[int, ...]]:
    """The shape of each slab of a scalar field."""
    n = fe1d.n_points(config["degree"], config["refinements"])
    return [(b - a,) + (n,) * (config["dim"] - 1)
            for a, b in bounds(config, n_slabs)]


def planes(parts, i0: int, i1: int, device, dtype=None) -> torch.Tensor:
    """Grid planes [i0, i1) of the field held as the slabs ``parts``, on
    ``device`` (in ``dtype``, default the slabs'): each shared plane from
    its left owner.  Each slab's planes are copied straight into the
    result, so no card holds more than the result and its own slab."""
    L = parts[0].shape[0] - 1
    out = torch.empty((i1 - i0,) + tuple(parts[0].shape[1:]),
                      dtype=dtype or parts[0].dtype, device=device)
    for s, t in enumerate(parts):
        lo = s * L
        # slab s gives its planes but the first, which its left neighbour
        # gives (slab 0 gives all of its own)
        a, b = max(i0, lo + (s > 0)), min(i1, lo + L + 1)
        if a < b:
            out[a - i0:b - i0].copy_(t[a - lo:b - lo])
    return out


def gather(parts, device, dtype=None) -> torch.Tensor:
    """The whole field of the slabs ``parts`` on ``device``: each shared
    plane from its left owner."""
    L = parts[0].shape[0] - 1
    return planes(parts, 0, L * len(parts) + 1, device, dtype)


def shared_planes(parts) -> float:
    """The largest difference between the two copies of any shared plane,
    relative to the largest |x| of the field (0 where the field is 0 and
    the copies agree)."""
    top = max(float(t.abs().max()) for t in parts)
    diff = max((float((parts[s][-1] - parts[s + 1][0].to(parts[s].device))
                      .abs().max()) for s in range(len(parts) - 1)),
               default=0.0)
    if top == 0:
        return 0.0 if diff == 0 else float("inf")
    return diff / top
