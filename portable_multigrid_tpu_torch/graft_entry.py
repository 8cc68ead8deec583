"""Entry points: one V-cycle of the main path, and a dry run of the
sharded solves.

Counterpart of the repository root's ``__graft_entry__.py``:

  * :func:`entry` returns one full V-cycle preconditioner application on
    the 3D Q4 Poisson hierarchy at r = 5 (2.1M DoFs) and its arguments:
    every level above the coarsest B.1 with a fused smoother on trimmed
    state (the exact operator for the residuals, the ``"mxu"`` core for the
    recurrence), B.3 between trimmed levels, plain Chebyshev-as-solver on
    the coarsest; fixed Chebyshev bounds, as the JAX function builds it
    by default (its ``PMG_ENTRY_EIG_SETUP`` switch, which runs the setup's
    eigenvalue estimate instead, is not carried over);
  * :func:`dryrun_multichip` runs the sharded solves the JAX function runs
    for ``n_devices`` shards, on a device list that repeats one card (or
    the CPU): the slab solve (extended-domain padding for a count that is
    not a power of two), the kernel path against the single device's CG
    count, and the 2D-pencil solve.

Both run on the card unless the caller passes a CPU device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .fem.mesh import HyperCubeMesh, geometric_coarsening_sequence
from .fem.space import FESpace
from .models.poisson import GeometricMultigridPoisson
from .ops.cuda_laplace import make_cuda_laplace
from .ops.cuda_transfer import make_cuda_h_transfer
from .parallel.extended import ExtendedShardedPoisson
from .parallel.mesh2d import Sharded2DGeometricPoisson
from .parallel.poisson import ShardedGeometricPoisson
from .parallel.sharding import ShardedCudaLaplace, ShardedFusedChebyshev
from .solvers.chebyshev import (
    Chebyshev,
    FusedChebyshev,
    np_dtype,
)
from .solvers.vcycle import MGLevel, VCycle, wire_trimmed


def entry(device="cuda"):
    """(fn, args): ``fn(*args)`` is one V-cycle of the main path's
    production hierarchy at Q4 r=5 in float32 on ``device``, applied to a
    seeded masked random rhs."""
    device = torch.device(device)
    dim, degree, refinements = 3, 4, 5
    dtype = torch.float32
    dt = np_dtype(dtype)
    spaces = [FESpace(m, degree) for m in
              geometric_coarsening_sequence(HyperCubeMesh(dim, refinements))]
    levels = []
    prev_trim = False
    for i, sp in enumerate(spaces):
        op = make_cuda_laplace(sp, dtype, device)
        theta, delta = float(dt(1.1)), float(dt(0.9))
        deg = 16 if i == 0 else 5
        if i > 0:
            smoother = FusedChebyshev(
                degree=deg, op=op, theta=theta, delta=delta,
                op_smooth=make_cuda_laplace(sp, dtype, device, core="mxu"))
        else:
            smoother = Chebyshev(degree=deg, op=op, theta=theta, delta=delta)
        trim = bool(getattr(smoother, "trimmed_io", False))
        transfer = None
        if i > 0:
            transfer = make_cuda_h_transfer(spaces[i - 1], sp, dtype, device,
                                            coarse_trimmed=prev_trim)
        prev_trim = trim
        levels.append(MGLevel(op=op, smoother=smoother, transfer=transfer))
    levels, fine_trim = wire_trimmed(levels)
    mg = VCycle(pre_smoothing_steps=2, post_smoothing_steps=2,
                fine_trimmed=fine_trim, levels=tuple(levels))
    fine = spaces[-1]
    rhs = torch.as_tensor(np.random.default_rng(0).standard_normal(
        fine.grid_shape) * fine.free_mask(), dtype=dtype, device=device)

    def fn(mg, rhs):
        return mg.apply(rhs)

    return fn, (mg, rhs)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The sharded solves over ``n_devices`` shards on one device repeated
    (the card by default), in float64 as the JAX function runs under
    ``jax_enable_x64``; each must converge, the kernel path in the single
    device's CG count.  Prints the JAX function's lines and returns the
    stats of each solve it ran, by ``"1d"`` (the slab solve), ``"kernel"``
    and ``"2d"``, with the ``(degree, refinements)`` of the float64 ones
    under ``"1d_size"`` and ``"2d_size"``."""
    device = torch.device("cuda" if device is None else device)
    devices = [device] * n_devices
    dtype, rtol = torch.float64, 1e-10
    pow2 = n_devices & (n_devices - 1) == 0
    if not pow2:
        # extended-domain padding: floor(log2 S) + 1 refinements, two
        # sharded levels
        ref1 = int(math.floor(math.log2(n_devices))) + 1
        prob = ExtendedShardedPoisson(3, 2, ref1, devices=devices,
                                      dtype=dtype)
    else:
        ref1 = max(int(math.ceil(math.log2(n_devices))), 0) + 1
        prob = ShardedGeometricPoisson(3, 2, ref1, devices=devices,
                                       dtype=dtype, variant="kron")
    _, stats = prob.solve(rtol=rtol)
    out = {"1d": stats, "1d_size": (2, ref1)}
    assert stats.converged, f"sharded solve did not converge: {stats}"
    print(f"dryrun_multichip({n_devices}): 1D mesh — {stats.n_dofs} DoFs "
          f"over {stats.n_shards} shards, {stats.iterations} CG iterations, "
          f"residual {stats.residual_norm:.3e}")
    if pow2:
        # the kernel path (B.1's slab, B.2's xext) on slabs of at least two
        # cells: 8 shards need r = 4 (16 cells)
        S = min(n_devices, 8)
        ref = 4 if S > 4 else 3
        pp = ShardedGeometricPoisson(3, 4, ref, devices=devices[:S],
                                     dtype=torch.float32, variant="auto")
        assert any(isinstance(lvl.op, ShardedCudaLaplace)
                   for lvl in pp.levels), "kernel path not active"
        assert any(isinstance(lvl.smoother, ShardedFusedChebyshev)
                   for lvl in pp.levels), "fused smoother not active"
        _, stp = pp.solve(rtol=1e-5)
        assert stp.converged, f"sharded kernel solve did not converge: {stp}"
        _, st1 = GeometricMultigridPoisson(3, 4, ref, dtype, "sumfac",
                                           device).solve(rtol=1e-5)
        assert stp.iterations == st1.iterations, (
            f"kernel-path iteration mismatch: sharded {stp.iterations} vs "
            f"single-device {st1.iterations}")
        print(f"dryrun_multichip({n_devices}): kernel path — {stp.n_dofs} "
              f"DoFs over {S} shards, {stp.iterations} CG iterations "
              f"(single-device {st1.iterations}), residual "
              f"{stp.residual_norm:.3e}")
        out["kernel"] = stp
    if n_devices >= 4 and pow2:
        sx = n_devices // 2
        ref2 = max(int(math.ceil(math.log2(sx))), 1) + 1
        prob2 = Sharded2DGeometricPoisson(3, 2, ref2, mesh_shape=(sx, 2),
                                          devices=devices, dtype=dtype)
        _, st2 = prob2.solve(rtol=rtol)
        assert st2.converged, f"2D-mesh solve did not converge: {st2}"
        print(f"dryrun_multichip({n_devices}): 2D mesh {st2.mesh_shape} — "
              f"{st2.n_dofs} DoFs, {st2.iterations} CG iterations, "
              f"residual {st2.residual_norm:.3e}")
        out["2d"], out["2d_size"] = st2, (2, ref2)
    return out
