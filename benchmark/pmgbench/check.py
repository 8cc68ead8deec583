"""The comparison that decides ``correct``.

After the window has closed, the plain reference of the configuration
(``configs/<reference>.py``), built anew from the mesh and the degree in
float64, takes the right-hand side that the benchmark handed the program
for each solve of the window's sample (drawn from the seed, and the solve
with the most CG iterations beside it) and solves it exactly; the program's
solution x of that solve is judged against it.  The numbers:

  * ``error``: the largest relative error ||x - x_ref|| / ||x_ref|| of the
    sample (2-norms over the whole grid);
  * ``residual``: the largest true relative residual ||b - A x|| / ||b||
    of the sample, A the reference operator;
  * ``cg_iterations_max``: the most CG iterations any solve of the window
    took;
  * ``failed``: the solves of the window that did not reach the traffic's
    tolerance within its iteration limit.

A cell on S > 1 cards keeps each sampled x as its slabs along grid axis 0
(``slabs.py``) and hands the check b_k as slabs too.  There ``error`` and
``residual`` are taken over the whole grid, each shared plane of x from
its left owner, with the configuration's blocked reference (``make_blocked``
beside ``make``), a block of planes at a time: the residual from x's and
b's slabs, then the gathered b solved in place.  A further number:

  * ``shared_planes``: the largest difference between the two copies of
    any shared plane of a sampled x, relative to max |x|.

``checks/<workload>.json`` gives the limits; a number without a limit
there is read (``calibrate.py`` prints it) and not compared.
"""

from __future__ import annotations

import torch

from . import slabs


def readings(cell, window, device) -> dict:
    if cell.chips > 1:
        return slab_readings(cell, window, device)
    ref = cell.reference().make(cell.config, device, torch.float64)
    norm = torch.linalg.vector_norm
    error = residual = 0.0
    for k, x in sorted(window.sample.items()):
        b = window.stream.rhs(k).to(torch.float64)
        x = x.to(torch.float64)
        want = ref.solve(b)
        error = max(error, float(norm(x - want) / norm(want)))
        residual = max(residual, float(norm(b - ref.apply(x)) / norm(b)))
    return {"error": error, "residual": residual,
            "cg_iterations_max": max(window.iterations),
            "failed": sum(not c for c in window.converged)}


def slab_readings(cell, window, device) -> dict:
    """:func:`readings` of a multi-card cell, its solutions and right-hand
    sides held as slabs; the reference on ``device``."""
    ref = cell.reference().make_blocked(cell.config, device, torch.float64)
    f64 = torch.float64
    error = residual = shared = 0.0
    for k, x in sorted(window.sample.items()):

        def planes(i0, i1, parts=x):
            return slabs.planes(parts, i0, i1, device, f64)

        shared = max(shared, slabs.shared_planes(x))
        b = window.stream.rhs(k)
        r2 = b2 = 0.0
        for i0, i1 in ref.blocks():
            bi = slabs.planes(b, i0, i1, device, f64)
            r2 += float((bi - ref.apply_rows(planes, i0, i1)).square().sum())
            b2 += float(bi.square().sum())
        residual = max(residual, (r2 / b2) ** 0.5)
        want = ref.solve_(slabs.gather(b, device, f64))
        del b
        e2 = w2 = 0.0
        for i0, i1 in ref.blocks():
            wi = want[i0:i1]
            e2 += float((planes(i0, i1) - wi).square().sum())
            w2 += float(wi.square().sum())
        del want
        error = max(error, (e2 / w2) ** 0.5)
    return {"error": error, "residual": residual, "shared_planes": shared,
            "cg_iterations_max": max(window.iterations),
            "failed": sum(not c for c in window.converged)}


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}} of the numbers compared):
    correct when every number with a limit is at or under it."""
    shown = {k: {"value": values[k], "limit": lim}
             for k, lim in limits.items()}
    return all(s["value"] <= s["limit"] for s in shown.values()), shown
