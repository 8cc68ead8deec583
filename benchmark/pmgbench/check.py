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

``checks/<workload>.json`` gives the limits; a number without a limit
there is read (``calibrate.py`` prints it) and not compared.
"""

from __future__ import annotations

import torch


def readings(cell, window, device) -> dict:
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


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}} of the numbers compared):
    correct when every number with a limit is at or under it."""
    shown = {k: {"value": values[k], "limit": lim}
             for k, lim in limits.items()}
    return all(s["value"] <= s["limit"] for s in shown.values()), shown
