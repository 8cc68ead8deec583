"""Polynomial-multigrid driver of the port (the reference's second program).

2D Poisson on the unit square, f ≡ 1, homogeneous Dirichlet everywhere,
one mesh with the polynomial ladder p_l = fe_degree - (mg_levels - 1 - l)
(reference: source/polynomial_multigrid/program.cc:149-159), V(2,2) with
Chebyshev(5) smoothing, CG to rtol * ||b||; refinement cycles like the
reference (:407,439-443).  Prints DoF counts, CG iteration counts and
solution L2 norms in the format of the JAX driver
(programs/polynomial_multigrid.py).

Usage:
  python -m portable_multigrid_tpu_torch.programs.polynomial_multigrid
         [--dim 2] [--degree 7] [--levels 7] [--cycles 7] [--f32]
         [--rtol R] [--variant auto|kron|sumfac|dense] [--device cuda]
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=2)
    ap.add_argument("--degree", type=int, default=7)
    ap.add_argument("--levels", type=int, default=7)
    ap.add_argument("--cycles", type=int, default=7)
    ap.add_argument("--f32", action="store_true",
                    help="solve in float32 (default float64)")
    ap.add_argument("--rtol", type=float, default=None)
    ap.add_argument("--variant", default="auto",
                    choices=["sumfac", "dense", "kron", "auto"],
                    help="auto: the CUDA kernels (their plain twins on CPU); "
                         "sumfac, dense, kron: the plain operator variants")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    args = ap.parse_args(argv)

    import torch

    from portable_multigrid_tpu_torch.models.poisson import (
        PolynomialMultigridPoisson,
    )
    from portable_multigrid_tpu_torch.programs import require_device

    device = require_device(args.device)
    dtype = torch.float32 if args.f32 else torch.float64
    rtol = args.rtol if args.rtol is not None else (1e-5 if args.f32 else 1e-12)

    print(
        f"============== fe_degree = {args.degree}, "
        f"mg_levels = {args.levels} ==============\n"
    )
    for cycle in range(args.cycles):
        print(f"\nCycle {cycle}")
        refinements = (3 - args.dim) + cycle  # reference: refine(3-dim) + 1/cycle
        t0 = time.time()
        prob = PolynomialMultigridPoisson(
            args.dim, args.degree, refinements, args.levels, dtype=dtype,
            variant=args.variant, device=device,
        )
        prob.solve(rtol=rtol, verbose=True)
        print(f"  (wall: {time.time() - t0:.2f}s)\n")


if __name__ == "__main__":
    main()
