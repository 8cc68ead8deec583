"""Unstructured-mesh multigrid driver of the port (the JAX package's
``programs/unstructured_multigrid.py``).

h-multigrid Poisson on a fully unstructured (perturbed) hex/quad mesh:
native orientation-matched DoF enumeration, indexed matrix-free operators,
per-cell embedding transfers — the capability layer the reference inherits
from deal.II but never exercises (its drivers run cubes only; reference:
source/geometric_multigrid/program.cc:409-417).  f ≡ 1, homogeneous
Dirichlet on the whole boundary, V(2,2) with Chebyshev(5), CG to
rtol * ||b|| in float64, on the card unless ``--device cpu`` is given.
Prints the JAX driver's lines, and after ``setup:`` the host seconds of
each setup step and which DoF enumerator ran (the native one, or its
Python twin where the native library cannot be built).

Usage:
  python -m portable_multigrid_tpu_torch.programs.unstructured_multigrid
         [--dim 3] [--degree 2] [--refinements 2] [--base-cells 2]
         [--amplitude 0.15] [--rtol 1e-12] [--vtu out.vtu] [--device cuda]
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    """Set up, solve and (with ``--vtu``) write the solution; returns the
    SolveStats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--degree", type=int, default=2)
    ap.add_argument("--refinements", type=int, default=2)
    ap.add_argument("--base-cells", type=int, default=2)
    ap.add_argument("--amplitude", type=float, default=0.15)
    ap.add_argument("--rtol", type=float, default=1e-12)
    ap.add_argument("--vtu", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)

    import torch

    from portable_multigrid_tpu_torch.fem.general_mesh import (
        perturbed_cube_mesh,
    )
    from portable_multigrid_tpu_torch.models.general_geometry import (
        UnstructuredMultigrid,
    )
    from portable_multigrid_tpu_torch.native import native_available
    from portable_multigrid_tpu_torch.programs import require_device

    device = torch.device(require_device(args.device))
    gm = perturbed_cube_mesh(args.dim, args.base_cells, args.amplitude)
    t0 = time.time()
    prob = UnstructuredMultigrid(gm, args.degree, args.refinements,
                                 device=device)
    print(f"setup: {time.time() - t0:.2f} s")
    print("setup by step: " + ", ".join(
        f"{step} {s:.2f} s" for step, s in prob.setup_seconds.items()))
    print(f"DoF enumerator: {'native' if native_available() else 'python'}")
    t0 = time.time()
    x, st = prob.solve(rtol=args.rtol, verbose=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"solve: {time.time() - t0:.2f} s")
    if args.vtu:
        prob.output_vtu(args.vtu, x)
        print(f"wrote {args.vtu}")
    return st


if __name__ == "__main__":
    main()
