"""Geometric-multigrid driver of the port (the reference's first program).

dim-D Poisson on the unit hyper-cube (3D by default), f ≡ 1, homogeneous
Dirichlet everywhere, h-multigrid V(2,2) with Chebyshev(5) smoothing, CG to
rtol * ||b||.  Sweeps fe_degree = 1..max_degree and refinement cycles
(9 - dim by default), printing DoF counts, CG
iteration counts and solution L2 norms in the format of the JAX driver
(programs/geometric_multigrid.py) and the reference (reference:
source/geometric_multigrid/program.cc:189-199,354-355,395).

With ``--sharded`` the solve is the slab-sharded one
(``parallel/poisson.py`` ``ShardedGeometricPoisson``, its default variant
``sumfac``, as the JAX driver's): one shard per CUDA card, or one shard on
the CPU with ``--device cpu``.  With ``--vtu`` each solve's solution is
written to ``solution_p{degree}_c{cycle}.vti`` in the working directory, as
the JAX driver writes it.

Usage:
  python -m portable_multigrid_tpu_torch.programs.geometric_multigrid
         [--dim 3] [--max-degree 7] [--cycles N]
         [--variant auto|kron|sumfac|dense] [--f32] [--rtol R] [--device cuda]
         [--sharded] [--vtu]
"""

from __future__ import annotations

import argparse
import time


def main(argv=None) -> list:
    """Run the sweep; returns the SolveStats of every solve, in order."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dim", type=int, default=3)
    ap.add_argument("--max-degree", type=int, default=7)
    ap.add_argument("--cycles", type=int, default=None,
                    help="refinement cycles (default: 9 - dim, as the reference)")
    ap.add_argument("--variant", default="auto",
                    choices=["sumfac", "dense", "kron", "auto"],
                    help="auto: the CUDA kernels (their plain twins on CPU); "
                         "sumfac, dense, kron: the plain operator variants")
    ap.add_argument("--f32", action="store_true",
                    help="solve in float32 (default float64)")
    ap.add_argument("--rtol", type=float, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only when asked)")
    ap.add_argument("--sharded", action="store_true",
                    help="shard the solve over every card (one shard on "
                         "the CPU with --device cpu)")
    ap.add_argument("--vtu", action="store_true",
                    help="write solution .vti files")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from portable_multigrid_tpu_torch.models.poisson import (
        GeometricMultigridPoisson,
    )
    from portable_multigrid_tpu_torch.parallel.poisson import (
        ShardedGeometricPoisson,
    )
    from portable_multigrid_tpu_torch.programs import require_device

    device = require_device(args.device)
    # every card, or the one device asked for
    devices = (None if torch.device(device).type == "cuda"
               else [torch.device(device)])
    dtype = torch.float32 if args.f32 else torch.float64
    rtol = args.rtol if args.rtol is not None else (1e-5 if args.f32 else 1e-12)
    cycles = args.cycles if args.cycles is not None else 9 - args.dim

    stats = []
    for degree in range(1, args.max_degree + 1):
        print(f"============== fe_degree = {degree} ============== \n")
        for cycle in range(cycles):
            print(f"\nCycle {cycle}")
            # a 2D mesh starts one refinement finer, as in the JAX driver
            refinements = (3 - args.dim if args.dim < 3 else 0) + cycle + 1
            t0 = time.time()
            if args.sharded:
                prob = ShardedGeometricPoisson(args.dim, degree, refinements,
                                               devices=devices, dtype=dtype)
            else:
                prob = GeometricMultigridPoisson(
                    args.dim, degree, refinements, dtype=dtype,
                    variant=args.variant, device=device,
                )
            x, st = prob.solve(rtol=rtol, verbose=True)
            stats.append(st)
            print(f"  (wall: {time.time() - t0:.2f}s)")
            if args.vtu:
                from portable_multigrid_tpu_torch.utils.vtu import write_vti

                if isinstance(x, torch.Tensor):
                    x = x.detach().cpu().numpy()
                write_vti(f"solution_p{degree}_c{cycle}.vti",
                          prob.spaces[-1],
                          {"solution": np.asarray(x, dtype=np.float64)})
            print()
    return stats


if __name__ == "__main__":
    main()
