"""Drive the PyTorch / CUDA port once on an NVIDIA card, end to end.

    python3 chip_smoke.py
    python3 chip_smoke.py --main-path   # phases 1, 4 and 5 alone
    python3 chip_smoke.py --general-geometry   # phases 1 and 19 alone
    python3 chip_smoke.py --b5-hashes FILE
    python3 chip_smoke.py --compare-hashes FILE FILE

``--main-path`` builds the kernels, then solves and times the main path
alone (for A/B runs of kernel variants, each from its own tree, in one
call); ``--general-geometry`` builds them and runs phase 19 alone; neither
prints a result line.  ``--b5-hashes`` builds the kernels and
writes the SHA-256 of every output of every cube B.5 mode (both cores,
float32 and float64) at phase 8's shapes, on phase 8's seeded inputs, to
FILE (JSON); it imports nothing that the port's earlier trees lack, so
that the same script copied into two trees' checkouts gives an A/B of
their B.5 outputs, which ``--compare-hashes`` counts as equal or not (no
card needed).  Neither prints a result line.

Phases (each raises on failure; nothing is allowed to fall back to the CPU
or from the CUDA graph to the eager V-cycle):

  1. card and build — the card's name and power limit, then the kernels
     built from ``portable_multigrid_tpu_torch/csrc`` (one nvcc per source,
     all at once; build time printed), and ptxas's registers, stack frame
     and spills of every kernel instance;
  2. kernel vs twin — every mode of every kernel against its plain torch
     twin on the card, in float32 and float64: the 3D kernels (B.1-B.3) at
     p = 1..7, r = 2 and at every level shape of the Q4 r = 6 main path
     (p = 4, r = 1..6: trimmed 8^3 to 256^3, and B.1 on the 1-cell
     level's 4^3, r = 0) and of the p -> h ladder of phase 12 (p = 1,
     r = 0..6, B.1 alone at r = 0; p = 2, r = 6); the 2D kernel (B.4) at
     p = 1..7, r = 2 and 3 (partial columns) and at every level shape of
     the Q7 r = 9 ladder ((512 p)^2, p = 1..7: 512^2 to 3584^2); bound 1e-5
     (f32) / 1e-12 (f64) on the max error relative to the twin's max
     magnitude; B.1's untrimmed ``residual`` (u and rhs random on the
     full grid, its last planes included) at every 3D shape, f32 and f64;
     in float32 at every one of these shapes also the bf16
     smoother grade of the JAX package's main path: B.1's ``residual3t``
     with bf16 r0 and d0, B.1's ``"mxu"`` core on the cheb family at bf16
     state and on ``residual``, and B.4's ``residual3t`` and cheb family
     at bf16 state, each held point by point as B.2 below is
     (:func:`flip_check`, with a witness whose first output is cut to
     bf16 toward zero) and within BF16_BOUND (1e-2) of the max;
     B.2's ``cheb2lr`` (``PMG_CHEB2R=1``) at the exact grade wherever its
     tile fits (p <= 5 in float32, p <= 3 in float64; elsewhere
     ``make_cheb2(op, rout=True)`` must refuse the level); B.2's six modes
     and ``cheb2lr`` at the production grade (made from the mxu operator)
     and bf16 state on three draws each, held point by point to the size
     of their sums (:func:`flip_stats`): no point off by more than
     FLIP_CAP of it (a few bf16 roundings that fall the other way), and
     no more than FLIP_SHARE of the points off by more than FLIP_FLOOR of
     it; a twin with one rounding point planted wrong (``cheb2``: r1 and
     d1 stored in bf16 between the steps; ``cheb2lr``: r2 rounded before
     the residual) must exceed FLIP_SHARE on the same draw;
  3. golden replay — the ``geometric_3d`` rows (p = 1..7, r = 1..3) and the
     ``polynomial_2d`` rows of tests/golden_convergence.json in float64
     through the kernels: CG counts exact, L2 norms to 1e-10;
  4. main path — GeometricMultigridPoisson(3, 4, 6, float32, "auto") on the
     card, solved to rtol 1e-5 eagerly (``graph=False``), which gives the
     launch count of each of its kernels (B.1, B.2, B.3) by mode and grade
     (``residual3t/bf16`` and B.2's ``/mxu/bf16`` modes must launch: the
     default builds the JAX package's bf16 grade on every float32 kernel
     level), and through the CUDA graph of the V-cycle (the model's
     default): the same CG count,
     the solutions within GRAPH_BOUND of each other (bit for bit
     expected); converged in <= 4 iterations, L2 norm within 1e-5 of
     0.0249871331, every tensor on the card; the capture's seconds;
  5. timing of the main path — CUDA events, warm-up then the median of 10
     runs: the eager and the graphed V-cycle, each with B.2 pairs and with
     B.1 single steps in their place (the smoothers' ``op_cheb2`` set to
     None; B.1's mxu core must launch there), each at the bf16 grade (the
     default) and at the exact float32 grade (the fine levels' smoothers
     swapped back to the exact operator at float32 state, as the JAX
     package's tests build it), CG count of each, in turns, the default
     eager one's split by level,
     the profiler's device-busy share of both against their unprofiled
     wall times and the kernel split, the whole solve, and each 3D kernel
     mode against its twin at r = 6 (and, in the log only, the kernel's
     device time: 10 calls back to back behind a device spin that lets the
     host enqueue them all, which leaves the host's launch work out),
     beside its bound (the larger of its bytes over the HBM rate and its
     FMAs over the FP32 rate, or over the bf16 tensor-core rate where the
     mode's products take bf16 operands, the ``mxu`` grades; B.1's modes
     summed up on one line with their
     roofline shares), each B.2 mode beside two B.1 ``cheb`` passes (the
     work one pair replaces) and, for B.3, beside one PyTorch call that
     computes the same function (``library_ms``: an einsum over the three
     axes, ``add_`` for ``prolongate_and_add``); and the main path as
     ``PMG_CHEB2R=1`` builds it (B.2's ``cheb2lr`` on every smoothing
     level), solved eagerly and graphed as in phase 4: converged in at most
     one CG iteration more than the default, L2 within 1e-5 of
     0.0249871331, one eager V-cycle with six ``cheb2lr/mxu/bf16`` and no
     ``residual1t`` launches, its V-cycles in turns with the others, and
     ``cheb2lr`` beside the pair and ``residual1t`` that it replaces;
  6. second path — the reference's second driver,
     PolynomialMultigridPoisson(2, 7, 9, 7, "auto") on the card (12.8M
     DoFs, p = 7..1 on one mesh): in float64 to rtol 1e-12 (<= 6 CG
     iterations and the count of the plain "kron" path, L2 within 1e-9 of
     that path's and 1e-7 of the mesh-converged 0.0412614897); in float32
     to rtol 1e-5 (<= 4 iterations, L2 within 1e-3 of the float64 value);
     each kernel solve eager and graphed as in phase 4; every tensor on
     the card and the B.4 launch count raised by each eager run;
  7. timing of the second path — the eager and the graphed V-cycle in
     turns (ms, DoF/s), the eager one's split by level with the p = 1
     coarse solve on its own line, the busy share of both and B.4's
     device time per V-cycle by degree, the V-cycle at the exact float32
     grade beside the default bf16 state, the CG solve, each B.4 mode
     against its twin at 3584^2, and at every level of the ladder its B.4
     launches per V-cycle (from the profile) and the device time of its
     busiest mode, ``cheb``, against the bound (on the p = 1 level too,
     the 512^2 coarse solve);
  8. elasticity kernel vs twin — every mode of B.5, and of B.3 on [3, ...]
     fields (one launch, the component a grid axis of the kernel),
     against its twin in float32 and float64, with mu = 0.7, lam = 1.3 (at
     mu = lam a swap of G and G^T or of mu and lam would not show), at
     p = 1..7, r = 2 and 3 (partial tiles) and at every other level shape
     of the Q3 r = 6 solve, p = 3, r = 1, 4, 5, 6 (3 x 192^3); the bounds
     of phase 2; in float32 at every one of these shapes also every mode
     of B.5's bf16 ``"mxu"`` core (float32 state), point by point as in
     phase 2 and within BF16_BOUND;
  9. elasticity replay — ElasticityMultigrid(3, p, r, float64, "auto") to
     rtol 1e-12 at (p, r) = (2, 2), (3, 2), (3, 3): CG counts equal and L2
     norms within 1e-10 of the JAX package's values pinned below;
 10. third path — the elasticity solve at full width,
     ElasticityMultigrid(3, 3, 6, float32, "auto") on the card (21,567,171
     DoFs), to rtol 1e-5: converged, every tensor on the card, the B.5 and
     B.3 launch counts raised by the eager run, B.5's ``cheb/mxu`` and
     ``chebl/mxu`` among them (the JAX package's smoother grade); in
     float64 to rtol 1e-12 through B.5 and on the plain "kron" path: the
     same CG count, L2 norms within 1e-9; the float32 L2 norm within 1e-4
     of the float64 one, and its CG count no more than that of the exact
     grade's V-cycle; each kernel solve eager and graphed as in phase 4;
 11. timing of the third path — the eager and the graphed V-cycle at the
     mxu grade (the default) and at the exact grade in turns (ms, DoF/s),
     the eager one's split by level, the busy share of both, the CG solve,
     and each B.5 mode (both cores) and vector B.3 mode against its twin
     at 3 x 192^3 beside its bound (and B.3's beside its ``library_ms``);
     an eager V-cycle's B.5 launches at the mxu grade, which the
     tensor-core instance runs: 16 a smoothing level;
 12. config 3 at full width — MixedMultigridPoisson(3, 6, (1, 2, 4),
     float32, "auto"): 9 levels, p = 1 on 2^3..65^3 points, then p = 2 and
     p = 4 on the 64^3-cell mesh (16,974,593 DoFs); to rtol 1e-5, eager
     and graphed as in phase 4: converged, L2 within 1e-5 of 0.0249871331,
     every tensor on the card, the B.1, B.2 and B.3 launch counts raised
     by the eager run; in float64 to rtol 1e-12 through the kernels and on
     "kron": the same CG count, L2 norms within 1e-9; the eager and
     graphed V-cycle at the bf16 and the exact grade in turns (ms, DoF/s)
     and the eager one's split by level;
 13. config 5 at full width — MixedPrecisionPoisson(3, 4, 6, float32,
     "auto") to rtol 1e-12 (float64 CG on B.1's float64 apply, a float32
     graphed V-cycle): CG count within 2 of
     GeometricMultigridPoisson(3, 4, 6, float64, "auto")'s, L2 within
     1e-9 relative of it; then ``iterative_refinement`` of the same
     problem (inner: float32 CG to rtol 1e-6 on B.1 with the graphed
     V-cycle; outer: B.1's float64 apply): <= 5 cycles, residual <=
     1e-12 ||b||, x within 1e-10 max|x| of the float64 solve; the
     whole-solve ms of the three solves with their CG and cycle counts,
     and the float32 V-cycle eager and graphed at the bf16 and the exact
     grade in turns;
 14. config 4's variable coefficient at full width —
     GeometricMultigridPoisson(3, 4, 6, coefficient=c), c(x) = 1 + 0.5
     sum_d sin(3 x_d), on 64^3 cells (16,974,593 DoFs), every level a plain
     operator variant on full grids (no kernel of B.1-B.5 launches, which
     the phase checks): first the JAX package's float64 3D Q4 r=3 solve
     replayed on ``qdense`` and ``sumfac`` (CG count exact, L2 to 1e-10
     of the values pinned below); then float64 ``qdense`` and ``sumfac``
     to rtol 1e-12 (equal CG counts, L2 within 1e-10 relative) and
     float32 ``qdense``, ``sumfac`` and ``qbanded`` to rtol 1e-5 (each
     converged, L2 within 1e-5 relative of the float64 solve), through the
     graphed V-cycle, float32 ``qdense`` eagerly too as in phase 4; the
     setup seconds, one apply's device ms of each, and for each float32
     variant the eager and graphed V-cycle in turns (ms, DoF/s), the
     default ``qdense``'s with its busy share and split by level;
 15. the constant-coefficient variants — GeometricMultigridPoisson(3, 4,
     6, float32) on ``sumfac`` and on ``dense`` to rtol 1e-5 (<= 4 CG
     iterations, L2 within 1e-5 of 0.0249871331); config 3 as
     ``bench_all.py`` runs it, MixedMultigridPoisson(3, 6, (1, 2, 4),
     float32, "sumfac") (L2 within 1e-5 of the same); ElasticityMultigrid(3,
     3, 5, float64) on ``sumfac`` and ``dense`` to rtol 1e-12 (the
     ``kron`` solve's CG count, L2 within 1e-9); each solved through the
     graphed V-cycle, with its eager and graphed V-cycle ms in turns;
 16. the slab-sharded solve as S shards on one card — B.1's slab modes
     (``apply`` on x-full input, ``residual1f``, ``residual3f``,
     ``chebf``; exact and ``mxu`` core) within BOUND of their twins (the
     ``mxu`` core point by point and within BF16_BOUND) and B.2's
     ``xext`` pair at both grades (the production grade point by point,
     :func:`flip_stats`) at p = 1..7, r = 3, on shards 0,
     1 and 3 of 4, and on the Q4 r=6 slab (65 x 256 x 256 points in); each
     xext output against the single-device pair's at the same planes (the
     count equal bit for bit is logged); each mode timed on that slab
     beside its bound; ``ShardedGeometricPoisson(3, 4, 6, devices=[cuda:0]
     * 4, float32, "auto")`` to rtol 1e-5 against the single-device model
     at float32 state (the mxu recurrence and the production pairs): the
     same CG count, x within SHARD_X_BOUND of max |x|, L2 within 1e-5 of
     0.0249871331, every mode of SHARDED_KEYS launched; both eager
     V-cycles in turns, busy shares, launches per sharded V-cycle; S = 8
     at Q4 r=4 (two-cell slabs); the float64 plain path at Q2 r=4 against
     the single-device solve; with two or more cards, the main path
     across them;
 17. the 2D-pencil sharded solve as sx x sy pencils on one card — B.1's
     pencil ``apply`` within BOUND of its twin and B.2's pencil pair
     (``cheb2``, ``cheb2l``, ``cheb2f0``, ``cheb2f0l``; the exact grade
     within BOUND, the production grade point by point) at p = 1..7,
     r = 3 (odd p on the upper corner pencil of (2, 2), even p on an edge
     pencil of (4, 2)), and at
     Q4 r=6 on a corner (2, 2), an edge (4, 2) and an interior (4, 4)
     pencil; every pair output equal to the single-device pair's at the
     same points bit for bit (the count is logged and must be all); each
     mode timed on the (2, 2) pencil of Q4 r=6 beside its bound;
     ``Sharded2DGeometricPoisson(3, 4, 6, (2, 2), devices=[cuda:0] * 4,
     float32, "auto")`` to rtol 1e-5 against the single-device model at
     float32 state: the same CG count, x within SHARD_X_BOUND of max |x|,
     L2 within 1e-5 of 0.0249871331, every mode of PENCIL_KEYS launched;
     its eager V-cycle in turns with the single device's and phase 16's
     slab-sharded one, busy shares, launches per V-cycle; (4, 2) at Q4
     r=4; the float64 ``kron`` path at Q2 r=4 on (2, 2) against the
     single-device solve (L2 within 1e-12);
 18. the slab-sharded elasticity solve as S shards on one card — B.5's
     slab ``apply`` within BOUND of its twin in float32 and float64 at
     p = 1..7, r = 3 (shards 0, 1 and 3 of 4) and on shard 1 of the Q3
     r=6 slabs of S = 4 (3 x 49 x 192 x 192 in), mu = 0.7, lam = 1.3;
     the mode timed there beside its bound and its twin;
     ``ShardedElasticity(3, 3, 6, devices=[cuda:0] * 4, float32,
     "auto")`` to rtol 1e-5 against ``ElasticityMultigrid(3, 3, 6,
     float32, "auto")`` at the exact grade (``PMG_ELASTICITY_MXU=0``):
     converged, at most one CG iteration more (the sharded hierarchy
     stops at r = log2 S), L2 within F32_L2_BOUND_ELASTICITY of the
     single device's, ``apply/slab`` launched on every level (r = 2..6)
     and no cube B.5 mode; both eager V-cycles in turns, busy shares,
     launches per sharded V-cycle; the float64 ``sumfac`` path at Q2 r=3
     on 4 shards against the single-device solve (x within 1e-10 of max
     |x|); with two or more cards the same solve across them;
 19. general geometry (driver 3, ``models/general_geometry.py``; no TPU
     kernel lies on this path, so no kernel of the port: plain torch, its
     scatter a gather and a fixed-order sum) — the native DoF enumerator
     built and used; at small sizes in float64, the indexed apply,
     prolongate and restrict of the Cartesian, perturbed 2D and 3D, curved
     (Q3 annulus) and unstructured operators on the card within
     GENERAL_BOUND of the port on the CPU and bit for bit equal over two
     calls; ``UnstructuredMultigrid`` (3D Q2, base 2, 1 refinement) and
     ``GeneralGeometryMultigrid`` (2D Q2 r=3) within GENERAL_X_BOUND of
     their dense oracles' solves, graphed equal to eager; then at full
     width (a) driver 3, ``unstructured_multigrid --dim 3 --degree 2
     --base-cells 4 --refinements 4 --vtu`` in a child process (2,146,689
     DoFs on 5 levels, <= 8 CG iterations, the .vtu written; the same
     problem built in this process meanwhile for its timings), (b)
     ``GeneralGeometryMultigrid`` on the perturbed 32^3 cube, Q4 r=5
     (2,146,689 DoFs, <= 12), (c) ``CurvedMultigrid`` on the annulus, Q3
     r=8 (591,361 DoFs, <= 8 and within one of the JAX package's count at
     r=7; at r=2 and r=3 its counts exactly, and the L2 error falling at a
     rate above p + 0.6); for each the host
     setup by step, the solves eager and graphed, the fine apply's device
     time beside its byte bound, the eager and the graphed V-cycle in
     turns, their busy shares and the device launches per eager V-cycle;
 20. the untrimmed path — ``build_untrimmed_vcycle`` over the main path's
     spaces (the JAX package's ``bench.py`` with ``PMG_BENCH_TRIMMED=0``:
     ``FusedChebyshev(trimmed_io=False)`` on every smoothing level at the
     bf16 grade, plain h-transfers on full grids), under CG to rtol 1e-5
     from counts set to 0: at most 4 CG iterations, the count of the
     trimmed single-step path, graphed equal to eager, L2 within 1e-5 of
     0.0249871331; B.1's ``residual`` and ``/mxu/bf16`` steps launched,
     no trimmed residual, pair or B.3; its V-cycle eager and graphed in
     turns with the single-step path's, busy shares, launches by mode;
     ``utils.profiling.measure_op`` beside the CUDA-event mean and one
     ``utils.profiling.trace`` written; B.1 ``residual``'s time against
     its bound; one V-cycle of ``graft_entry.entry()``;
 21. any shard count on one card — ``ExtendedShardedPoisson(3, 4, 6,
     devices=[cuda:0] * 3, float64)`` (96 x 64 x 64 extended cells,
     25.4M points a vector) and S = 6 at Q4 r=4, to rtol 1e-10 against
     the single-device ``kron`` solve: at most 2 CG iterations more (at S
     = 6, the JAX package's pinned count), the live x within 1e-9 of max
     |x|, each eager V-cycle in turns with the single device's, and busy
     shares; then ``graft_entry.dryrun_multichip(3)`` and ``(8)``, whose
     float64 slab and pencil solves' CG counts and L2 are held against
     the single device's (no timing: 729 to 35,937 DoFs).

Every phase's seconds, and the total, are printed at the end.

The line before the last is a JSON object with one entry per kernel and
grade that its path launched (``cheb2lr`` from the ``PMG_CHEB2R=1`` solve
of phase 5; ``laplace/slab``, ``laplace/slab/mxu`` and ``cheb2/xext/mxu``
from phase 16's sharded solve; ``laplace/pencil`` and ``cheb2/pencil/mxu``
from phase 17's pencil solve; ``elasticity/slab`` from phase 18's sharded
elasticity solve; ``laplace/residual``, B.1's untrimmed residual, from
phase 20's path); the last line is the result object.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections.abc import Callable
from typing import NamedTuple

import numpy as np
import torch

from portable_multigrid_tpu_torch import _build, graft_entry, native
from portable_multigrid_tpu_torch.fem.assemble import assemble_rhs_indexed
from portable_multigrid_tpu_torch.fem.general_mesh import (
    curved_structured_geometry,
    perturbed_cube_mesh,
    refine_general_mesh,
)
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.models.elasticity import ElasticityMultigrid
from portable_multigrid_tpu_torch.models.general_geometry import (
    CurvedMultigrid,
    FlatTransfer,
    GeneralGeometryMultigrid,
    UnstructuredMultigrid,
)
from portable_multigrid_tpu_torch.models.mixed import (
    MixedMultigridPoisson,
    MixedPrecisionPoisson,
)
from portable_multigrid_tpu_torch.models.poisson import (
    GeometricMultigridPoisson,
    PolynomialMultigridPoisson,
    build_untrimmed_vcycle,
)
from portable_multigrid_tpu_torch.ops import (
    cuda_cheb2,
    cuda_elasticity,
    cuda_laplace,
    cuda_laplace2d,
    cuda_transfer,
)
from portable_multigrid_tpu_torch.native import enumerate_dofs, native_available
from portable_multigrid_tpu_torch.ops.indexed import (
    dense_indexed_operator,
    dense_unstructured_operator,
    make_indexed_laplace,
    make_unstructured_h_transfer,
    make_unstructured_laplace,
)
from portable_multigrid_tpu_torch.ops.structured import exact_matmuls
from portable_multigrid_tpu_torch.ops.cuda_laplace2d import apply_trimmed_2d
from portable_multigrid_tpu_torch.ops.elasticity import elasticity_kron
from portable_multigrid_tpu_torch.ops.transfer import (
    make_h_transfer,
    trim_last_planes,
)
from portable_multigrid_tpu_torch.parallel.extended import (
    ExtendedShardedPoisson,
)
from portable_multigrid_tpu_torch.parallel.mesh2d import (
    Sharded2DGeometricPoisson,
    _build_pencil_cheb2,
    _build_pencil_kernel,
)
from portable_multigrid_tpu_torch.parallel.poisson import (
    ShardedGeometricPoisson,
    _build_stacked_cheb2,
    _build_stacked_slab,
)
from portable_multigrid_tpu_torch.solvers.cg import cg
from portable_multigrid_tpu_torch.solvers.refinement import iterative_refinement
from portable_multigrid_tpu_torch.solvers.chebyshev import FusedChebyshev
from portable_multigrid_tpu_torch.solvers.vcycle import GraphedVCycle, VCycle
from portable_multigrid_tpu_torch.utils import profiling

GOLDEN_L2_Q4_R6 = 0.0249871331
# bound on the float32 main path's L2 norm against the golden one: B.1, the
# CG operator, contracts K in difference form (csrc/laplace.cu); the TPU
# kernel's direct sum left it 6.6e-5 off
F32_L2_BOUND_3D = 1e-5
# the mesh-converged 2D L2 norm, on which the three polynomial_2d golden
# rows agree to 1e-10
MESH_L2_2D = 0.0412614897
BOUND = {torch.float32: 1e-5, torch.float64: 1e-12}
# a kernel mode at the bf16 grade or bf16 state against its twin (mode keys
# with a "/": "cheb/mxu/bf16", "residual3t/bf16"): each output's max error
# over its max magnitude; a bf16 rounding may fall on the other side where
# the kernel's float32 sums differ in order from the twin's
BF16_BOUND = 1e-2
BF16 = torch.bfloat16
# B.2 at its production grade, held point by point to the magnitude S of
# the pair's sums there (flip_stats): a bf16 rounding that falls the other
# way moves the value it rounds by one bf16 step, at most 2^-7 of it, and
# an output by at most 2^-7 S; no point may be off by more than four such
# steps, and no more than FLIP_SHARE of the points by more than FLIP_FLOOR
# S, far above the float32 order of the sums (~5e-8 S).  On an H100 80GB
# HBM3 at 700 W, three draws at each phase 2 shape gave at most 3.2e-3 S
# and a share of 2.7e-3 for the kernel, and a share of 0.38 or more for
# each planted rounding (phase 2 logs all three for every case).  The same
# check holds B.1's and B.5's mxu cores and the bf16-state modes of B.1 and
# B.4, each with a witness whose first output is cut to bf16
# toward zero (planted_witness), and these stay within BF16_BOUND of the
# max as well
FLIP_CAP = 2.0 ** -5
FLIP_FLOOR = 2.0 ** -18
FLIP_SHARE = 5e-2
# the graphed solve against the eager one: max |x_graph - x_eager| over the
# eager solution's max magnitude, by the solution's dtype (bit for bit
# expected: the graph replays the same kernels in the same order)
GRAPH_BOUND = {torch.float32: 1e-6, torch.float64: 1e-12}
# CG bounds of the 2D Q7 r=9 ladder.  The float64 count rises with the mesh
# as the JAX package's does (the coarse Chebyshev-as-solver is capped at
# degree 512): 4 at r=4, 5 at r=5 and r=6, 6 at r=9.  The float32 solve
# lands within 1e-3 of the float64 L2 norm because B.4 contracts K in
# difference form (csrc/laplace2d.cu); the direct banded sum of the TPU
# kernel is 3.4e-2 off at r=9.
MAX_CG_2D = {torch.float64: 6, torch.float32: 4}
F32_L2_BOUND_2D = 1e-3
# CG counts and L2 norms of the JAX package's 3D elasticity solve (kron,
# float64, rtol 1e-12, mu = lam = 1) by (p, r), computed on the CPU; the CPU
# tests hold this table against the JAX package's live values
# (tests/test_torch_elasticity_model.py, _q3.py, _blocks.py)
ELASTICITY_F64 = {(2, 2): (4, 0.027343514900882587),
                  (3, 2): (5, 0.02736279346880834),
                  (3, 3): (6, 0.027367902132579464)}
MU_LAM = (0.7, 1.3)  # B.5 against its twin: mu != lam
LADDER_3 = (1, 2, 4)  # config 3's p-ladder, coarse to fine


def coefficient(*xs):
    """c(x) = 1 + 0.5 sum_d sin(3 x_d): BASELINE config 4's variable
    coefficient, as the JAX package's tests/test_solvers.py:153 has it."""
    out = 1.0
    for x in xs:
        out = out + 0.5 * np.sin(3 * x)
    return out


# The JAX package's float64 3D Q4 r=3 solve with this coefficient, rtol
# 1e-12, by PMG_VARCOEFF_VARIANT: (CG iterations, L2 norm), as its CPU run
# prints them from the repo root (and likewise with sumfac):
#   PMG_VARCOEFF_VARIANT=qdense python -c "import jax
#   jax.config.update('jax_platforms', 'cpu')
#   jax.config.update('jax_enable_x64', True)
#   import chip_smoke
#   from portable_multigrid_tpu.models.poisson import GeometricMultigridPoisson as G
#   s = G(3, 4, 3, coefficient=chip_smoke.coefficient).solve()[1]
#   print(s.iterations, repr(s.solution_l2_norm))"
VARCOEF_F64_R3 = {"qdense": (5, 0.012412695994480256),
                  "sumfac": (5, 0.01241269599448026)}
F32_L2_BOUND_ELASTICITY = 1e-4
# the H100 SXM's published HBM rate, FP32 rate outside the tensor cores and
# dense bf16 tensor-core rate (at the full 700 W power limit): the mxu
# grades' products take bf16 operands and accumulate in float32, the work
# of the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
# fine-level fields each mode reads once and writes once: B.1, B.4, B.5
# (u, r, x in; r, d, x out), B.2 (d, r, x in; r2, d2, x2 out) and B.3 (a
# coarse field is 1/8 of a fine one)
MODE_FIELDS = {"apply": 2, "residual1t": 3, "residual3t": 5, "cheb": 6,
               "residual": 4,
               "residual1f": 3, "residual3f": 5, "chebf": 6,
               "chebl": 4, "chebd": 5, "chebdl": 3, "cheb2": 6, "cheb2l": 4,
               "chebd2": 5, "chebd2l": 3, "cheb2f0": 4, "cheb2f0l": 2,
               "cheb2lr": 5, "restrict": 1.125, "prolongate": 1.125,
               "prolongate_and_add": 2.125}
# banded products of 2p+1 FMAs per grid point of each operator kernel:
# B.1 M A M u in sum-factorised form (2 along z, 3 along y, 2 along x),
# B.2 two of them (``cheb2lr`` three), B.4 its 2D form (2 + 2), B.5 the 21
# elasticity chains (12 along z, 21 along y, 12 along x); by kernel
PRODUCTS = {"laplace": 7, "cheb2": 14, "cheb2lr": 21, "laplace2d": 4,
            "elasticity": 45}
# Each kernel names the path that launches it and the (p, r) of that path's
# fine level, where its mode times and errors are reported.
KERNELS = {
    "laplace": dict(route="cuda",
                    source="portable_multigrid_tpu_torch/csrc/laplace.cu",
                    replaces="portable_multigrid_tpu/ops/pallas_laplace.py:212",
                    counts=cuda_laplace.LAUNCHES, path="3d", shape=(4, 6)),
    "cheb2": dict(route="cuda",
                  source="portable_multigrid_tpu_torch/csrc/cheb2.cu",
                  replaces="portable_multigrid_tpu/ops/pallas_cheb2.py:168",
                  counts=cuda_cheb2.LAUNCHES, path="3d", shape=(4, 6)),
    # B.2's rout=True: the main path with PMG_CHEB2R=1 ("cheb2r") runs it
    "cheb2lr": dict(route="cuda",
                    source="portable_multigrid_tpu_torch/csrc/cheb2lr.cu",
                    replaces="portable_multigrid_tpu/ops/pallas_cheb2.py:168",
                    counts=cuda_cheb2.ROUT_LAUNCHES, path="cheb2r",
                    shape=(4, 6)),
    "transfer": dict(route="cuda",
                     source="portable_multigrid_tpu_torch/csrc/transfer.cu",
                     replaces="portable_multigrid_tpu/ops/pallas_transfer.py:154",
                     counts=cuda_transfer.LAUNCHES, path="3d", shape=(4, 6)),
    "laplace2d": dict(route="cuda",
                      source="portable_multigrid_tpu_torch/csrc/laplace2d.cu",
                      replaces="portable_multigrid_tpu/ops/pallas_laplace2d.py:137",
                      counts=cuda_laplace2d.LAUNCHES, path="2d", shape=(7, 9)),
    "elasticity": dict(route="cuda",
                       source="portable_multigrid_tpu_torch/csrc/elasticity.cu",
                       replaces="portable_multigrid_tpu/ops/pallas_elasticity.py:164",
                       counts=cuda_elasticity.LAUNCHES, path="elasticity",
                       shape=(3, 6)),
}


def path_kernels(path: str) -> list[str]:
    return [name for name, k in KERNELS.items() if k["path"] == path]


def log(msg: str) -> None:
    print(msg, flush=True)


def synchronize(device) -> None:
    """Bring a fault in a kernel to light where it happened."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def space(p: int, r: int, dim: int = 3) -> FESpace:
    return FESpace(HyperCubeMesh(dim, r), p)


def masked_trimmed(op, rng, dtype, device) -> torch.Tensor:
    """A random field on the trimmed grid (components leading, for
    elasticity), zero on constrained entries."""
    shape = op.trimmed_shape
    lead = len(shape) - op.dim
    N = op.n * op.degree
    m = np.ones(N)
    m[0] = 0.0
    v = rng.standard_normal(shape)
    for ax in range(lead, len(shape)):
        v = v * m.reshape([N if a == ax else 1 for a in range(len(shape))])
    return torch.as_tensor(v, dtype=dtype, device=device)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-300)


# scalars of the comparisons: theta = 1.3, delta = 0.9 recurrence coefficients
SCAL_RES3 = (1.3,)
SCAL_CHEB = (0.59, 1.26)
SCAL_PAIR = (0.59, 1.26, 0.71, 1.52)
SCAL_PAIR_F0 = SCAL_PAIR + (1.3,)


class Case(NamedTuple):
    """One kernel mode on one draw: the kernel call, its twin, the library
    yardstick (None where no one PyTorch call computes the function); for
    a mode at a bf16 grade (B.2's production grade, B.1's and B.5's mxu
    cores, B.1's and B.4's bf16 state) also the magnitudes of its sums per
    output (``mags``, held point by point by :func:`flip_stats`) and a
    twin with one rounding point planted wrong (``witness``), which the
    same check must refuse."""

    mode: str
    run: Callable
    twin: Callable
    lib: Callable | None = None
    mags: Callable | None = None
    witness: Callable | None = None


def trunc_bf16(t: torch.Tensor) -> torch.Tensor:
    """float32 t cut to bf16 toward zero (its low 16 bits cleared)."""
    return (t.float().contiguous().view(torch.int32) & -65536).view(
        torch.float32)


def mode_magnitudes(op, mode, u, ins=(), scal=()) -> tuple:
    """Per output of a B.1, B.4 or B.5 mode (cube, or B.1's slab), the
    magnitude S of its sums at each point: the mode on |u| and |inputs|
    with the operator's |bands| (K's row sums those of |K|: the direct
    sums; B.5's dense |K|, |M|, |G| in its chains), |scalars| and every
    subtraction an addition, in float64.  Each value that the mode rounds
    to bf16 (an input of a contraction, a product of a z or y stage, a
    stored r or d) is at most S in magnitude where it lands in an
    output."""
    T = torch.float64

    def a(t):
        return t.to(T).abs()

    slab = isinstance(op, cuda_laplace.CudaLaplaceSlab)
    base = cuda_laplace.SLAB_MODES[mode] if slab else mode
    if mode in getattr(op, "full_modes", ()):
        u, *ins = (trim_last_planes(t, op.dim) for t in (u, *ins))
    u, ins = a(u), [a(t) for t in ins]
    if isinstance(op, cuda_elasticity.CudaElasticityOperator):
        raw = elasticity_kron(u, a(op.Kt), a(op.Mt), a(op.Gt), a(op.Gt).T,
                              abs(op.mu), abs(op.lam))
    elif op.dim == 2:
        kb = a(op.kband)
        raw = apply_trimmed_2d(kb, kb.sum(0), a(op.mband), u)
    else:
        kb, xb = a(op.kband), None
        if slab:
            xk = a(op.xkband)
            xb = (xk, xk.sum(0), a(op.xmband))
        raw = cuda_laplace.apply_trimmed(kb, kb.sum(0), a(op.mband), u,
                                         False, xb)
        u = u[:raw.shape[0]]
    diag = op.diag_trimmed().to(T).abs()
    sc = [abs(float(v)) for v in scal]
    if base == "apply":
        return (raw,)
    r = ins[0] + raw
    if base == "residual1t":
        return (r,)
    if base in ("residual", "residual3t"):
        d = r / (sc[0] * diag)
        return (r, d) if base == "residual" else (r, d, u + d)
    x = u if base in ("chebd", "chebdl") else ins[1]
    d = sc[0] * u + (sc[1] / diag) * r
    return (x + d,) if base in ("chebl", "chebdl") else (r, d, x + d)


def planted_witness(op, mode, u, ins=(), scal=(), sdtype=None) -> tuple:
    """The twin with one rounding point planted wrong: its first output
    taken at the operator's own state dtype (float32, unrounded where the
    mode stores it in bf16) and cut to bf16 toward zero, where the kernel
    rounds to nearest even or does not round at all; its other outputs
    the twin's."""
    want = op.twin(mode, u, ins, scal, sdtype=sdtype)
    first = op.twin(mode, u, ins, scal)[0]
    return (trunc_bf16(first).to(want[0].dtype),) + tuple(want[1:])


def bf16_case(key: str, op, mode: str, u, ins=(), scal=(),
              sdtype=None) -> Case:
    """The :class:`Case` of a B.1, B.4 or B.5 mode at a bf16 grade, held
    point by point (:func:`mode_magnitudes`, :func:`planted_witness`)."""
    return Case(key, lambda: op.run(mode, u, ins, scal, sdtype=sdtype),
                lambda: op.twin(mode, u, ins, scal, sdtype=sdtype),
                mags=lambda: mode_magnitudes(op, mode, u, ins, scal),
                witness=lambda: planted_witness(op, mode, u, ins, scal,
                                                sdtype))


def laplace_cases(op, rng, dtype, device, smooth_op=None):
    """A :class:`Case` for every B.1 / B.4 / B.5 mode on random state, and
    for B.1's untrimmed ``residual`` on random full-grid u and rhs (nonzero
    on the last planes, which it reads at zero weight); in float32 also
    the bf16 grade's modes of the JAX package's main path (keys as
    ``cuda_laplace.launch_key`` counts them): ``residual3t`` of ``op``
    with bf16 outputs and the cheb family of ``smooth_op`` (B.1's mxu core;
    ``op`` itself in 2D) at bf16 state, and B.1's ``residual`` on the mxu
    core; for B.5, which keeps float32 state, every mode of ``smooth_op``
    (its mxu core).  The bf16 grade's cases are held point by point."""
    u, r, x = (masked_trimmed(op, rng, dtype, device) for _ in range(3))
    args = {"apply": ((), ()), "residual1t": ((r,), ()),
            "residual3t": ((r,), SCAL_RES3), "cheb": ((r, x), SCAL_CHEB),
            "chebl": ((r, x), SCAL_CHEB), "chebd": ((r,), SCAL_CHEB),
            "chebdl": ((r,), SCAL_CHEB)}
    for mode, (ins, scal) in args.items():
        yield Case(mode, lambda m=mode, i=ins, s=scal: op.run(m, u, i, s),
                   lambda m=mode, i=ins, s=scal: op.twin(m, u, i, s))
    if "residual" in op.full_modes:
        uf, bf = (torch.as_tensor(rng.standard_normal(op.grid_shape),
                                  dtype=dtype, device=device)
                  for _ in range(2))
        yield Case("residual",
                   lambda: op.run("residual", uf, (bf,), SCAL_RES3),
                   lambda: op.twin("residual", uf, (bf,), SCAL_RES3))
        if smooth_op is not None:
            yield bf16_case(cuda_laplace.launch_key("residual",
                                                    smooth_op.core, None),
                            smooth_op, "residual", uf, (bf,), SCAL_RES3)
    if smooth_op is not None and not op.bf16_state:
        for mode, (ins, scal) in args.items():
            yield bf16_case(cuda_laplace.launch_key(mode, smooth_op.core,
                                                    None),
                            smooth_op, mode, u, ins, scal)
    if dtype != torch.float32 or not op.bf16_state:
        return
    yield bf16_case("residual3t/bf16", op, "residual3t", u, (r,), SCAL_RES3,
                    BF16)
    sop = op if smooth_op is None else smooth_op
    d16, r16 = u.to(BF16), r.to(BF16)
    for mode in ("cheb", "chebl", "chebd", "chebdl"):
        ins = (r16, x) if mode in ("cheb", "chebl") else (r16,)
        yield bf16_case(cuda_laplace.launch_key(mode, sop.core, BF16), sop,
                        mode, d16, ins, SCAL_CHEB, BF16)


def pair_magnitudes(op, d, r, x, scal, mode) -> tuple:
    """Per output of a B.2 mode, the magnitude S of its sums at each point:
    the twin's recurrence run on |d|, |r|, |x| with |K| and |M|, |scalars|
    and every subtraction an addition, in float64.  Each value the pair
    rounds to bf16 (an input of a contraction, a product of its z or y
    stage, a stored r2 or d2) is at most S in magnitude where it lands in
    an output."""
    T = torch.float64
    kb, mb = op.kband.to(T).abs(), op.mband.to(T).abs()

    def A(t):
        return cuda_laplace.apply_trimmed(kb, kb.sum(0), mb, t)

    diag = op.diag_trimmed().to(T).abs()
    c0a, c1a, c0b, c1b = (abs(float(c)) for c in scal[:4])
    d, r, x = (None if t is None else t.to(T).abs() for t in (d, r, x))
    if mode in ("cheb2f0", "cheb2f0l"):
        r, d = d, d / (abs(float(scal[4])) * diag)
        x = d
    elif mode in ("chebd2", "chebd2l"):
        x = d
    r1 = r + A(d)
    d1 = c0a * d + (c1a / diag) * r1
    r2 = r1 + A(d1)
    d2 = c0b * d1 + (c1b / diag) * r2
    x2 = x + d1 + d2
    if mode == cuda_cheb2.ROUT_MODE:
        return x2, r2 + A(d2)
    return (x2,) if mode.endswith("l") else (r2, d2, x2)


def cheb2_cases(kern, rng, dtype, device, sdtype=None):
    """A :class:`Case` for each of the six B.2 modes, with d and r stored
    in ``sdtype`` (keys as ``launch_key`` counts them); at bf16 state
    also their magnitudes, and for ``cheb2`` the witness that stores r1
    and d1 in bf16 between the steps, as two B.1 passes do."""
    op = kern.op
    d, r, x = (masked_trimmed(op, rng, dtype, device) for _ in range(3))
    b = d
    if sdtype is not None:
        d, r = d.to(sdtype), r.to(sdtype)
    args = {"cheb2": (d, r, x, SCAL_PAIR), "cheb2l": (d, r, x, SCAL_PAIR),
            "chebd2": (d, r, None, SCAL_PAIR),
            "chebd2l": (d, r, None, SCAL_PAIR),
            "cheb2f0": (b, None, None, SCAL_PAIR_F0),
            "cheb2f0l": (b, None, None, SCAL_PAIR_F0)}

    def two_steps():
        r1, d1, x1 = op.twin("cheb", d, (r, x), SCAL_PAIR[:2], sdtype=sdtype)
        return op.twin("cheb", d1, (r1, x1), SCAL_PAIR[2:], sdtype=sdtype)

    bf = sdtype == BF16
    for mode, a in args.items():
        yield Case(cuda_laplace.launch_key(mode, op.core, sdtype),
                   lambda m=mode, a=a: kern.steps2(*a, m, sdtype=sdtype),
                   lambda m=mode, a=a: cuda_cheb2.cheb2_twin(op, *a, m,
                                                             sdtype),
                   mags=(lambda m=mode, a=a: pair_magnitudes(op, *a, m))
                   if bf else None,
                   witness=two_steps if bf and mode == "cheb2" else None)


def cheb2lr_cases(op, rng, dtype, device, sdtype=None):
    """The :class:`Case` of B.2's ``cheb2lr`` on ``op``'s level where its
    tile fits, with d and r stored in ``sdtype``; at bf16 state also its
    magnitudes and the witness that rounds r2 to bf16 before the
    residual.  Where the tile does not fit, ``make_cheb2(op, rout=True)``
    must refuse the level, and nothing is yielded."""
    if not cuda_cheb2.cheb2_fits(op, rout=True):
        try:
            cuda_cheb2.make_cheb2(op, rout=True)
        except ValueError:
            return
        raise RuntimeError(f"cheb2lr p={op.degree} {op.dtype}: a tile was "
                           f"made where none fits")
    kern = cuda_cheb2.make_cheb2(op, rout=True)
    mode = cuda_cheb2.ROUT_MODE
    d, r, x = (masked_trimmed(op, rng, dtype, device) for _ in range(3))
    if sdtype is not None:
        d, r = d.to(sdtype), r.to(sdtype)

    def twin():
        return cuda_cheb2.cheb2_twin(op, d, r, x, SCAL_PAIR, mode, sdtype)

    def r2_rounded():
        # the pair's r2 in float32, then r_out + (bf16(r2) - r2)
        r2 = cuda_cheb2.cheb2_twin(op, d, r, x, SCAL_PAIR, "cheb2")[0]
        x2, r_out = twin()
        return x2, r_out + (r2.to(BF16).to(r2.dtype) - r2)

    bf = sdtype == BF16
    yield Case(cuda_laplace.launch_key(mode, op.core, sdtype),
               lambda: kern.steps2(d, r, x, SCAL_PAIR, mode, sdtype=sdtype),
               twin,
               mags=(lambda: pair_magnitudes(op, d, r, x, SCAL_PAIR, mode))
               if bf else None,
               witness=r2_rounded if bf else None)


def einsum3(W: torch.Tensor, src: torch.Tensor, add=None) -> torch.Tensor:
    """B.3's yardstick: one PyTorch call for (W (x) W (x) W) src, the field
    first so that it contracts one axis at a time (``add_`` for the
    addend).  Timed beside the kernel; the port never calls it."""
    out = torch.einsum("...ijk,ai,bj,ck->...abc", src, W, W, W)
    return out if add is None else out.add_(add)


def transfer_cases(tr, p, r, rng, dtype, device, lead=()):
    """B.3's modes on random trimmed fields, with ``lead`` = (3,) on the
    elasticity path's vector fields (one launch for all components)."""
    nf, nc = (2 ** r) * p, (2 ** (r - 1)) * p
    f, dst = (torch.as_tensor(rng.standard_normal(lead + (nf,) * 3),
                              dtype=dtype, device=device) for _ in range(2))
    c = torch.as_tensor(rng.standard_normal(lead + (nc,) * 3), dtype=dtype,
                        device=device)
    twin = cuda_transfer.transfer_twin
    R, P = tr.restrict_.dense, tr.prolong.dense
    yield Case("restrict", lambda: tr.restrict(f), lambda: twin(R, f),
               lambda: einsum3(R, f))
    yield Case("prolongate", lambda: tr.prolongate(c), lambda: twin(P, c),
               lambda: einsum3(P, c))
    yield Case("prolongate_and_add", lambda: tr.prolongate_and_add(dst, c),
               lambda: twin(P, c, dst), lambda: einsum3(P, c, dst))


def level_cases(path, p, r, dtype, device, draws: int = 1):
    """Every mode of the kernels of a path ("3d", "2d" or "elasticity", as
    in KERNELS) at one level shape: (kernel, :class:`Case`); B.2 at its
    production grade on ``draws`` draws."""
    rng = np.random.default_rng(0)
    if path == "2d":
        op = cuda_laplace2d.make_cuda_laplace2d(space(p, r, 2), dtype, device)
        for case in laplace_cases(op, rng, dtype, device):
            yield "laplace2d", case
        return
    mxu = None
    if path == "elasticity":
        op = cuda_elasticity.make_cuda_elasticity(space(p, r), dtype, *MU_LAM,
                                                  device)
        name, lead = "elasticity", (3,)
        if dtype == torch.float32:
            mxu = cuda_elasticity.make_cuda_elasticity(
                space(p, r), dtype, *MU_LAM, device, core="mxu")
    else:
        op = cuda_laplace.make_cuda_laplace(space(p, r), dtype, device)
        name, lead = "laplace", ()
        if dtype == torch.float32:
            mxu = cuda_laplace.make_cuda_laplace(space(p, r), dtype, device,
                                                 core="mxu")
    for case in laplace_cases(op, rng, dtype, device, mxu):
        yield name, case
    if r == 0:
        return  # the 1-cell level has no transfer and no pair kernel
    tr = cuda_transfer.make_cuda_h_transfer(space(p, r - 1), space(p, r),
                                            dtype, device)
    if path == "3d":
        for case in cheb2_cases(cuda_cheb2.make_cheb2(op), rng, dtype, device):
            yield "cheb2", case
        for case in cheb2lr_cases(op, rng, dtype, device):
            yield "cheb2lr", case
        for _ in range(draws if mxu is not None else 0):
            # the production grade at bf16 state, as the main path runs it
            for case in cheb2_cases(cuda_cheb2.make_cheb2(mxu), rng, dtype,
                                    device, BF16):
                yield "cheb2", case
            for case in cheb2lr_cases(mxu, rng, dtype, device, BF16):
                yield "cheb2lr", case
    for case in transfer_cases(tr, p, r, rng, dtype, device, lead=lead):
        yield "transfer", case


def flip_stats(got: tuple, want: tuple, mags: tuple) -> tuple:
    """(max |got - want| / S, share of the points with S > 0 where
    |got - want| > FLIP_FLOOR S, number of those points), the worst over
    the outputs, S the magnitudes of :func:`pair_magnitudes`; where S = 0
    (constrained points) the outputs must be equal."""
    worst, share, n = 0.0, 0.0, 0
    for g, w, m in zip(got, want, mags):
        diff = (g.double() - w.double()).abs()
        free = m > 0
        n = int(free.sum())
        if bool((diff[~free] > 0).any()):
            return float("inf"), 1.0, n
        if n == 0:
            continue  # every point constrained (the 1-cell level)
        q = diff[free] / m[free]
        worst = max(worst, float(q.max()))
        share = max(share, float((q > FLIP_FLOOR).double().mean()))
    return worst, share, n


def flip_check(name: str, c: Case, got: tuple, want: tuple,
               worst: float) -> tuple[str, bool]:
    """The point-by-point check of a bf16-grade :class:`Case`: (what it
    saw, passed).  Its witness, where it has one and the level more than
    one free point, must break the share (else this raises); B.1's, B.4's
    and B.5's modes stay within BF16_BOUND of the max (``worst``) too."""
    mags = c.mags()
    cap, share, n = flip_stats(got, want, mags)
    seen = (f"max err {cap:.3e} S (cap {FLIP_CAP:.2e}), share over "
            f"{FLIP_FLOOR:.1e} S {share:.2e} (bound {FLIP_SHARE:.0e})")
    ok = cap <= FLIP_CAP and share <= FLIP_SHARE
    # a share needs points: the one free point of p = 1, r = 1 shows none
    if c.witness is not None and n > 1:
        w_cap, w_share, _ = flip_stats(c.witness(), want, mags)
        planted = f"witness {w_cap:.3e} S, share {w_share:.2e}"
        seen += f"; {planted}"
        if not w_share > FLIP_SHARE:
            raise RuntimeError(f"{name}/{c.mode}: the planted rounding "
                               f"passes the check: {planted}")
    if name in ("laplace", "laplace2d", "elasticity"):
        seen += f"; max rel err {worst:.3e} (bound {BF16_BOUND:.0e})"
        ok = ok and worst <= BF16_BOUND
    return seen, ok


def compare(path, p, r, dtype, device, results) -> None:
    """Each kernel mode (and library yardstick) against its twin: the max
    error over the twin's max magnitude within its bound, or, at a bf16
    grade, within the flip limits point by point (:func:`flip_check`),
    which its witness must break."""
    for name, c in level_cases(path, p, r, dtype, device, draws=3):
        mode = c.mode
        got, want = c.run(), c.twin()
        synchronize(device)
        worst = 0.0
        bound = BF16_BOUND if "/" in mode else BOUND[dtype]
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if not torch.isfinite(g).all() or g.dtype != w.dtype:
                raise RuntimeError(f"{name}/{mode} p={p} r={r}: non-finite "
                                   f"or {g.dtype} where the twin has "
                                   f"{w.dtype}")
            # bf16 outputs compared in float32, float64 ones as they are
            wide = torch.promote_types(g.dtype, torch.float32)
            err, rel = rel_err(g.to(wide), w.to(wide))
            worst = max(worst, rel)
            key = (name, mode, p, r, str(dtype).split(".")[-1])
            results[key] = max(results.get(key, 0.0), err)
        # the yardstick must compute the same function to be one
        lib_rel = rel_err(c.lib(), want[0])[1] if c.lib else 0.0
        head = f"  {name:10s} {mode:19s} p={p} r={r} {str(dtype)[6:]:8s}"
        if c.mags is not None:
            seen, ok = flip_check(name, c, got, want, worst)
            log(f"{head} {seen}")
            if not ok:
                raise RuntimeError(f"{name}/{mode} p={p} r={r}: {seen}")
            continue
        log(f"{head} max rel err {worst:.3e} (bound {bound:.0e})")
        if not (worst <= bound and lib_rel <= bound):
            raise RuntimeError(f"{name}/{mode} p={p} r={r} {dtype}: relative "
                               f"error {worst:.3e} (library {lib_rel:.3e}) "
                               f"> {bound:.0e}")


def cuda_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median device time of fn() in ms (CUDA events around each run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Device time of one fn() in ms: CUDA events around ``reps`` calls
    back to back, queued behind a spin of the device long enough for the
    host to enqueue them all, so that the host's launch work (~60 us a
    wrapper call) stays out of the time, over ``reps``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    # twice the host's time for the batch, in cycles of a clock <= 2 GHz
    torch.cuda._sleep(int(2 * reps * host * 2e9) + 1000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def tensors_of(obj, seen=None):
    """Every tensor reachable from a level object's dataclass fields."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            yield from tensors_of(item, seen)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from tensors_of(getattr(obj, f.name), seen)


def reset_counts() -> None:
    for k in KERNELS.values():
        for mode in k["counts"]:
            k["counts"][mode] = 0


def check_on_card(prob, x, device, per_mode, what: str) -> None:
    """Every tensor of the solve on the card, each kernel of the path
    launched, the solution finite and of the fine grid's shape."""
    if not torch.isfinite(x).all() or tuple(x.shape) != prob.levels[-1].op.shape:
        raise RuntimeError(f"{what}: solution not finite or wrong shape")
    stray = [t for lvl in prob.levels for t in tensors_of(lvl)
             if t.device != x.device] + ([x] if x.device != device else [])
    if stray:
        raise RuntimeError(f"{what}: {len(stray)} tensors of the solve are "
                           f"off {device}")
    for name, counts in per_mode.items():
        if sum(counts.values()) == 0:
            raise RuntimeError(f"{what} never launched the {name} kernel")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(build_log: str) -> list[str]:
    """One line per kernel instance from nvcc's -Xptxas -v output: its
    registers per thread, stack frame (an array indexed at run time lands
    there) and spill bytes."""
    rows, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"((?:laplace2d|laplace|cheb2|rhs|transfer|"
                          r"restrict|prolong|elasticity)_kernel)I([fd])"
                          r"(?:Li(\d+)E)?(?:Lb([01])E)?(?:Lb([01])E)?",
                          m.group(1))
            name = (f"{k.group(1)}<{'float' if k.group(2) == 'f' else 'double'}"
                    f"{', ' + k.group(3) if k.group(3) else ''}"
                    f"{', bf16 grade' if k.group(4) == '1' else ''}"
                    f"{', cheb2lr' if k.group(5) == '1' else ''}>"
                    if k else m.group(1))
            rows[name] = ["?", "?", "?", "?"]
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            rows[name][1:] = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows[name][0] = m.group(1)
    return [f"{n}: {r} registers, stack {sf} B, spill stores {st} B, "
            f"loads {ld} B" for n, (r, sf, st, ld) in rows.items()]


def phase_build() -> str:
    """Phase 1: the card, and the kernels built from the checkout."""
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    lib = _build.build(force=True)
    log(f"phase 1: kernels built in {lib.build_seconds:.1f} s -> {lib.path.name}")
    for line in ptxas_report(lib.build_log):
        log(f"  ptxas: {line}")
    return card


def phase_compare(device, shapes, phase: int = 2) -> dict:
    """Phases 2 and 8: every kernel mode against its twin at (path, p, r,
    dtype) shapes; returns the max abs errors by (kernel, mode, p, r,
    dtype)."""
    log(f"phase {phase}: kernels vs plain twins")
    errs: dict = {}
    for path, p, r, dtype in shapes:
        compare(path, p, r, dtype, device, errs)
    log(f"phase {phase}: ok")
    return errs


def phase_golden(device, table) -> None:
    """Phase 3: golden CG counts and L2 norms in float64 through the kernels."""
    log("phase 3: golden replay, float64, variant auto")
    rows = [(r, GeometricMultigridPoisson, (3, r["degree"], r["refinements"]))
            for r in table["geometric_3d"]]
    rows += [(r, PolynomialMultigridPoisson,
              (2, r["degree"], r["refinements"], r["levels"]))
             for r in table["polynomial_2d"]]
    for row, model, args in rows:
        prob = model(*args, dtype=torch.float64, variant="auto", device=device)
        _, st = prob.solve()
        rel = abs(st.solution_l2_norm / row["l2_norm"] - 1.0)
        log(f"  {model.__name__} {args}: {st.iterations} "
            f"iterations (golden {row['iterations']}), L2 rel diff {rel:.2e}")
        if (not st.converged or st.iterations != row["iterations"]
                or rel > 1e-10 or st.n_dofs != row["n_dofs"]):
            raise RuntimeError(f"golden row {model.__name__} {args} does "
                               f"not match")
    log("phase 3: ok")


def solve_both(prob, rtol: float, names, what: str):
    """Solve eagerly (``graph=False``) and through the model's graphed
    V-cycle: the same CG count and solutions within GRAPH_BOUND, and every
    kernel in ``names`` launched by both (at capture, for the graph).
    Returns the graphed solution and stats and the eager run's launches
    by kernel and mode, counted since the last ``reset_counts``."""
    t0 = time.perf_counter()
    xe, se = prob.solve(rtol=rtol, graph=False)
    synchronize(prob.device)
    t_eager = time.perf_counter() - t0
    per_mode = {name: dict(KERNELS[name]["counts"]) for name in names}
    reset_counts()
    t0 = time.perf_counter()
    x, st = prob.solve(rtol=rtol, verbose=True)
    synchronize(prob.device)
    t_graph = time.perf_counter() - t0
    captured = {name: sum(KERNELS[name]["counts"].values()) for name in names}
    mg = prob.preconditioner()
    warm, capture = next(iter(mg.capture_seconds.values()))
    err = rel_err(x, xe)[1]
    log(f"  {what}: eager {se.iterations} CG iterations in {t_eager:.2f} s, "
        f"graphed {st.iterations} in {t_graph:.2f} s (warm-up {warm:.3f} s, "
        f"capture and instantiation {capture:.3f} s); graphed vs eager max "
        f"rel diff {err:.2e}; launches counted in the graphed solve "
        f"(capture, warm-up, CG operator) {captured}")
    if st.iterations != se.iterations or not err <= GRAPH_BOUND[x.dtype]:
        raise RuntimeError(f"{what}: graphed solve ({st.iterations} "
                           f"iterations) off the eager one ({se.iterations}) "
                           f"by {err:.2e}")
    if not isinstance(mg, GraphedVCycle) or 0 in captured.values():
        raise RuntimeError(f"{what}: the solve did not run the graphed "
                           f"V-cycle through every kernel: {captured}")
    del xe
    return x, st, per_mode


def phase_main(device, r: int, l2_ref: float, max_iterations: int):
    """Phase 4: the main path, counted from construction to solution."""
    log(f"phase 4: main path GeometricMultigridPoisson(3, 4, {r}, float32, auto)")
    synchronize(device)
    reset_counts()
    t0 = time.perf_counter()
    prob = GeometricMultigridPoisson(3, 4, r, torch.float32, "auto", device)
    synchronize(device)
    t_setup = time.perf_counter() - t0
    x, st, per_mode = solve_both(prob, 1e-5, path_kernels("3d"), "main path")
    log(f"  setup {t_setup:.2f} s; launches per mode (construction and the "
        f"eager solve): {per_mode}")
    l2_rel = abs(st.solution_l2_norm / l2_ref - 1.0)
    log(f"  CG iterations {st.iterations}, residual {st.residual_norm:.3e}, "
        f"L2 {st.solution_l2_norm:.10f}, "
        f"{st.solution_l2_norm - l2_ref:+.3e} from the golden {l2_ref} "
        f"(rel diff {l2_rel:.2e})")
    if not (st.converged and st.iterations <= max_iterations):
        raise RuntimeError(f"main path: converged={st.converged} in "
                           f"{st.iterations} iterations")
    if l2_rel > F32_L2_BOUND_3D:
        raise RuntimeError(f"main path L2 norm off by {l2_rel:.2e}")
    check_on_card(prob, x, device, per_mode, "main path")
    check_grade(per_mode, "3d", "main path")
    check_pairs_on_tensor_cores(prob, x, "main path")
    log("phase 4: ok")
    return prob, st, per_mode


def time_turns(vcycles: dict, rhs, reps: int = 10, warmup: int = 3) -> dict:
    """The median ms of ``reps`` applies of each V-cycle, taken in turns in
    the dict's order and back: name -> [first, second]; ``rhs`` one input
    for all, or a dict of them by name."""
    runs = {name: [] for name in vcycles}
    for name in list(vcycles) + list(vcycles)[::-1]:
        src = rhs[name] if isinstance(rhs, dict) else rhs
        runs[name].append(cuda_ms(lambda v=vcycles[name]: v.apply(src), reps,
                                  warmup))
    return runs


def log_launches(mg, rhs) -> None:
    """Each kernel's launches in one eager V-cycle, by mode."""
    reset_counts()
    mg.apply(rhs)
    synchronize(rhs.device)
    counts = {name: {m: n for m, n in k["counts"].items() if n}
              for name, k in KERNELS.items()}
    log(f"  launches per eager V-cycle: "
        f"{ {k: v for k, v in counts.items() if v} }")
    reset_counts()


def graph_report(card: str, prob, rhs, n_dofs: int, vcycles=None,
                 reps: int = 10, warmup: int = 3):
    """The eager and the graphed V-cycle of a model (or the named pairs of
    ``vcycles``) in turns, ms and DoF/s (median of ``reps``), then the
    profiler's busy share of the first eager and the first graphed one
    against their unprofiled wall times.  Returns (mean ms by name, the
    eager profile's rows)."""
    if vcycles is None:
        vcycles = {"eager": prob.preconditioner(graph=False),
                   "graphed": prob.preconditioner()}
    runs = time_turns(vcycles, rhs, reps, warmup)
    log_launches(vcycles[next(iter(vcycles))], rhs)
    for name, ts in runs.items():
        log(f"  V-cycle {name:16s}: {ts[0]:.3f} / {ts[1]:.3f} ms = "
            f"{n_dofs / (min(ts) * 1e-3):.4e} DoF/s ({n_dofs} DoFs) [{card}]")
    wall = {name: statistics.mean(ts) for name, ts in runs.items()}
    eager, graphed = (next(k for k, v in vcycles.items()
                           if isinstance(v, GraphedVCycle) == g)
                      for g in (False, True))
    rows = device_busy(vcycles[eager], rhs, wall[eager], eager)
    device_busy(vcycles[graphed], rhs, wall[graphed], graphed)
    busy = sum(r[0] for r in rows)
    log(f"  device work of the eager V-cycle over the graphed one's wall: "
        f"{busy:.3f} / {wall[graphed]:.3f} ms = "
        f"{100 * busy / wall[graphed]:.1f}%; graphed / eager wall "
        f"{wall[graphed] / wall[eager]:.3f} [{card}]")
    return wall, rows


def log_levels(prob, rhs, name=lambda k, sp: f"r={k}") -> None:
    """The graphed V-cycle's own time by level: ``GraphedVCycle.span_ms``
    of 10 replays of the traced graph (the device clock, inside the
    graph); a level's own time is its pre, restrict, prolongate and post
    spans, the coarsest level's its coarse solve."""
    mg = prob.preconditioner()
    with profiling.tracing():
        mg.apply(rhs)  # captures the traced graph
        mg.span_ms()
        for _ in range(10):
            mg.apply(rhs)
        spans = mg.span_ms()
    own = [spans["vcycle.coarse"].ms] + [
        sum(spans[f"vcycle.L{k}.{ph}"].ms
            for ph in ("pre", "restrict", "prolongate", "post"))
        for k in range(1, len(prob.levels))]
    for k, (sp, lvl) in enumerate(zip(prob.spaces, prob.levels)):
        what = "coarse solve" if k == 0 else "smoothing, residual, transfers"
        log(f"  level {name(k, sp)} ({lvl.op.n_dofs} DoFs, {what}): "
            f"{own[k]:.3f} ms ({100 * own[k] / sum(own):.1f}%)")


def cheb2r_path(prob, st, device):
    """The main path with ``PMG_CHEB2R=1``, built as a user would build it
    (B.2's ``cheb2lr`` on every smoothing level: the last pre-smoothing pair
    gives the residual that is restricted), solved eagerly and graphed as
    in phase 4: converged in at most one CG iteration more than the
    default (the JAX package's pinned trade-off), L2 within 1e-5 of the
    golden value; one eager V-cycle launches ``cheb2lr/mxu/bf16`` once on
    each of the six smoothing levels and ``residual1t`` never.  Returns the
    model and the eager solve's launches."""
    os.environ["PMG_CHEB2R"] = "1"
    try:
        prob_r = GeometricMultigridPoisson(3, 4, 6, torch.float32, "auto",
                                           device)
    finally:
        del os.environ["PMG_CHEB2R"]
    reset_counts()
    x, st_r, per_mode = solve_both(prob_r, 1e-5, path_kernels("3d")
                                   + path_kernels("cheb2r"),
                                   "main path, PMG_CHEB2R=1")
    l2_rel = abs(st_r.solution_l2_norm / GOLDEN_L2_Q4_R6 - 1.0)
    log(f"  PMG_CHEB2R=1: CG iterations {st_r.iterations} (default "
        f"{st.iterations}), L2 {st_r.solution_l2_norm:.10f} (rel diff "
        f"{l2_rel:.2e} from the golden {GOLDEN_L2_Q4_R6}); launches "
        f"{per_mode}")
    if not (st_r.converged and st_r.iterations <= st.iterations + 1
            and l2_rel <= F32_L2_BOUND_3D):
        raise RuntimeError(f"PMG_CHEB2R=1 main path: converged="
                           f"{st_r.converged} in {st_r.iterations} "
                           f"iterations, L2 off by {l2_rel:.2e}")
    check_on_card(prob_r, x, device, per_mode, "main path, PMG_CHEB2R=1")
    reset_counts()
    prob_r.preconditioner(graph=False).apply(prob_r.rhs())
    synchronize(device)
    rout = cuda_cheb2.ROUT_LAUNCHES.get("cheb2lr/mxu/bf16", 0)
    res1 = cuda_laplace.LAUNCHES["residual1t"]
    log(f"  PMG_CHEB2R=1: one eager V-cycle launches cheb2lr/mxu/bf16 "
        f"{rout} times, residual1t {res1}")
    reset_counts()
    if rout != len(prob_r.levels) - 1 or res1:
        raise RuntimeError(f"PMG_CHEB2R=1 V-cycle: {rout} cheb2lr and "
                           f"{res1} residual1t launches")
    return prob_r, per_mode


def phase_timing(card: str, prob, st, device, per_mode) -> dict:
    """Phase 5: V-cycle, CG solve and every kernel mode vs its twin; the
    ``PMG_CHEB2R=1`` path's launches of ``cheb2lr`` join ``per_mode``."""
    log(f"phase 5: timing on {card} (CUDA events, median of 10)")
    rhs = prob.rhs()
    fine_op = prob.levels[-1].op
    n_dofs = prob.spaces[-1].n_dofs
    prob_r, per_mode_r = cheb2r_path(prob, st, device)
    per_mode["cheb2lr"] = per_mode_r["cheb2lr"]
    vcycles = {}
    for label, exact in (("", False), ("exact ", True)):
        for pairs in (True, False):
            v = grade_vcycle(prob, pairs, exact)
            kind = "pairs" if pairs else "singles"
            vcycles[f"{label}{kind} eager"] = v
            vcycles[f"{label}{kind} graphed"] = GraphedVCycle(v)
    vcycles["cheb2r eager"] = prob_r.preconditioner(graph=False)
    vcycles["cheb2r graphed"] = prob_r.preconditioner()
    for name, v in vcycles.items():
        its = cg(fine_op.apply, rhs, v.apply, rtol=1e-5).iterations
        kind = ("pairs and cheb2lr" if "cheb2r" in name else
                "pairs" if "pairs" in name else "off")
        log(f"  {name} ({'exact float32' if 'exact' in name else 'bf16'} "
            f"grade, B.2 {kind}): CG {its} iterations to rtol 1e-5")
    # B.1's mxu core runs the recurrence's single steps
    reset_counts()
    vcycles["singles eager"].apply(rhs)
    synchronize(device)
    check_grade({"laplace": dict(cuda_laplace.LAUNCHES)}, "singles",
                "singles V-cycle")
    reset_counts()
    graph_report(card, prob, rhs, n_dofs, vcycles)
    log_levels(prob, rhs)
    mg = vcycles["pairs graphed"]
    t_solve = cuda_ms(lambda: cg(fine_op.apply, rhs, mg.apply, rtol=1e-5),
                      warmup=1)
    log(f"  CG solve to rtol 1e-5 ({st.iterations} iterations, graphed "
        f"V-cycle): {t_solve:.3f} ms = {n_dofs / (t_solve * 1e-3):.4e} DoF/s")
    del vcycles, mg, prob_r
    p, r = KERNELS["laplace"]["shape"]
    t_two = two_single_steps_ms(p, r, device)
    t_two16 = two_single_steps_ms(p, r, device, bf16=True)
    log(f"  two B.1 cheb passes (the work of one B.2 pair): {t_two:.3f} ms; "
        f"at the mxu grade and bf16 state {t_two16:.3f} ms")
    times = time_modes("3d", p, r, device)
    log(f"  B.1 at {2 ** r * p}^3: " + ", ".join(
        f"{mode} {t['ms']:.3f} ms (bound {t['bound_ms']:.4f}, "
        f"{100 * t['bound_ms'] / t['ms']:.1f}%)"
        for (name, mode), t in times.items() if name == "laplace"))
    for (name, mode), t in times.items():
        if name == "cheb2":
            two = t_two16 if "/" in mode else t_two
            log(f"  cheb2 {mode:18s} {t['ms']:.3f} ms vs two B.1 passes "
                f"{two:.3f} ms ({two / t['ms']:.2f}x), bound "
                f"{t['bound_ms']:.4f} ms, twin {t['plain_ms']:.3f} ms")
    # cheb2lr replaces the last pre-smoothing pair (cheb2l) and residual1t
    for grade in ("", "/mxu/bf16"):
        t = times[("cheb2lr", "cheb2lr" + grade)]
        pair = times[("cheb2", "cheb2l" + grade)]["ms"]
        res1 = times[("laplace", "residual1t")]["ms"]
        log(f"  cheb2lr {'cheb2lr' + grade:16s} {t['ms']:.3f} ms vs the pair and "
            f"residual1t it replaces {pair:.3f} + {res1:.3f} = "
            f"{pair + res1:.3f} ms, bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}), twin {t['plain_ms']:.3f} ms")
    log("phase 5: ok")
    return times


def grade_vcycle(prob, pairs: bool = True, exact: bool = False) -> VCycle:
    """The model's V-cycle with its fused smoothers changed, nothing else:
    ``pairs`` False runs every B.2 pair as two B.1 single steps (the
    smoothers' pair kernel removed); ``exact`` swaps the bf16 grade of the
    float32 levels (B.1's mxu core at bf16 state, B.5's mxu core) back to
    the exact operator at float32 state, its B.2 kernels made from the
    exact operator, as the JAX package's tests build the exact grade."""
    def change(sm):
        if not isinstance(sm, FusedChebyshev):
            return sm
        if exact and (sm.state_dtype is not None
                      or sm.op_smooth is not None):
            sm = dataclasses.replace(
                sm, op_smooth=None, state_dtype=None,
                op_cheb2=sm.op_cheb2 and cuda_cheb2.make_cheb2(sm.op),
                op_cheb2r=sm.op_cheb2r and cuda_cheb2.make_cheb2(
                    sm.op, rout=True))
        return sm if pairs else dataclasses.replace(sm, op_cheb2=None,
                                                    op_cheb2r=None)

    levels = tuple(dataclasses.replace(lvl, smoother=change(lvl.smoother))
                   for lvl in prob.levels)
    return VCycle(levels=levels, fine_trimmed=prob.fine_trimmed,
                  io_dtype=prob.io_dtype)


def grade_vcycles(prob, pairs: bool = True) -> dict:
    """The model's eager and graphed V-cycle at its default (bf16) grade,
    then at the exact float32 grade, for :func:`graph_report`."""
    out = {}
    for label, exact in (("", False), ("exact ", True)):
        eager = (prob.preconditioner(graph=False) if not exact
                 else grade_vcycle(prob, pairs, exact))
        out[f"{label}eager"] = eager
        out[f"{label}graphed"] = (prob.preconditioner() if not exact
                                  else GraphedVCycle(eager))
    return out


# the bf16 grade's modes that must launch on a path (a key ending in each
# suffix, by kernel): the exact residual3t with bf16 outputs and the
# production pairs in 3D; B.1's mxu core where the single steps run
# (B.2 pairs take every step of a degree-5 smoother, as in the JAX
# package); B.4 at bf16 state in 2D
GRADE_MODES = {"3d": {"laplace": ("residual3t/bf16",),
                      "cheb2": ("/mxu/bf16",)},
               "singles": {"laplace": ("residual3t/bf16", "/mxu/bf16")},
               "2d": {"laplace2d": ("residual3t/bf16", "chebl/bf16")},
               "elasticity": {"elasticity": ("cheb/mxu", "chebl/mxu")}}


def moved_launches(counts: dict, prob, rhs) -> dict:
    """The launches of ``counts`` (a LAUNCHES dict) that one eager V-cycle
    of ``prob`` adds, by key."""
    before = dict(counts)
    prob.preconditioner(graph=False).apply(rhs)
    synchronize(rhs.device)
    return {k: v - before.get(k, 0) for k, v in counts.items()
            if v != before.get(k, 0)}


def check_pairs_on_tensor_cores(prob, rhs, what: str) -> None:
    """One eager V-cycle of a float32 model launches every B.2 pair at the
    production grade (``/mxu/bf16``), which the tensor-core instance
    runs."""
    moved = moved_launches(cuda_cheb2.LAUNCHES, prob, rhs)
    log(f"  {what}: B.2 pairs a V-cycle {moved}")
    if not moved or not all(k.endswith("/mxu/bf16") for k in moved):
        raise RuntimeError(f"{what}: pairs {moved}, not all at /mxu/bf16")


def check_elasticity_on_tensor_cores(prob, rhs, what: str) -> None:
    """One eager V-cycle of a float32 elasticity model launches B.5 at the
    mxu grade (``/mxu`` keys, which the tensor-core instance runs) 16
    times on each smoothing level."""
    moved = {k: v for k, v in
             moved_launches(cuda_elasticity.LAUNCHES, prob, rhs).items()
             if k.endswith("/mxu")}
    levels = len(prob.levels) - 1
    per_level = sum(moved.values()) / levels
    log(f"  {what}: B.5 at the mxu grade a V-cycle {moved}, "
        f"{per_level:g} on each of {levels} smoothing levels")
    if per_level != 16:
        raise RuntimeError(f"{what}: mxu launches {moved}")


def check_grade(counts: dict, path: str, what: str) -> None:
    """Each mode of GRADE_MODES[path] launched at least once."""
    for name, suffixes in GRADE_MODES[path].items():
        got = {k: v for k, v in counts[name].items() if "/" in k and v}
        log(f"  {what}: {name} launches at the bf16 grade {got}")
        for suffix in suffixes:
            if not any(k.endswith(suffix) for k in got):
                raise RuntimeError(f"{what}: no {name} mode *{suffix} "
                                   f"launched ({counts[name]})")


def two_single_steps_ms(p: int, r: int, device, bf16: bool = False) -> float:
    """Two chained B.1 cheb passes at one level shape, in float32: the
    yardstick of a B.2 pair (``bf16``: of the production pair, on the mxu
    core at bf16 state)."""
    op = cuda_laplace.make_cuda_laplace(space(p, r), torch.float32, device,
                                        core="mxu" if bf16 else "banded")
    sd = BF16 if bf16 else None
    rng = np.random.default_rng(1)
    d, r_, x = (masked_trimmed(op, rng, torch.float32, device)
                for _ in range(3))
    if bf16:
        d, r_ = d.to(BF16), r_.to(BF16)

    def two():
        r1, d1, x1 = op.run("cheb", d, (r_, x), SCAL_CHEB, sdtype=sd)
        return op.run("cheb", d1, (r1, x1), SCAL_CHEB, sdtype=sd)

    return cuda_ms(two)


def mode_bytes(name: str, mode: str) -> int:
    """Bytes a mode moves per grid point (and component): MODE_FIELDS
    float32 fields, or at bf16 state the streams as ``io_dtypes`` (B.2:
    its own table) stores them."""
    base, _, grade = mode.partition("/")
    if "bf16" not in grade:
        return MODE_FIELDS[base] * 4
    f32 = torch.float32
    if name in ("cheb2", "cheb2lr"):
        ins = ((f32,) if base.startswith("cheb2f0") else
               (BF16, BF16) + ((f32,) if base in ("cheb2", "cheb2l",
                                                  "cheb2lr") else ()))
        outs = ((f32, f32) if base == "cheb2lr" else
                (f32,) if base.endswith("l") else (BF16, BF16, f32))
    else:
        ins, outs = cuda_laplace.io_dtypes(base, f32, BF16)
    return sum(torch.empty((), dtype=t).element_size() for t in ins + outs)


def bound(path, name, mode, p, r) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take
    for one pass of the mode at this shape — each input read once and each
    output written once at the HBM rate (float32 fields, bf16 state streams
    at 2 bytes), against the FMAs of this shape's operator at the FP32
    rate, or at the bf16 tensor-core rate on an ``mxu`` grade, whose
    products take bf16 operands."""
    dim = 2 if path == "2d" else 3
    N = 2 ** r * p  # the fine level's trimmed extent
    comps = 3 if path == "elasticity" else 1
    nbytes = mode_bytes(name, mode) * comps * N ** dim
    if name == "transfer":
        # sum-factorised (W (x) W (x) W): the nonzeros of W times the
        # columns each axis's contraction runs over
        tr = cuda_transfer.make_cuda_h_transfer(space(p, r - 1), space(p, r),
                                                torch.float64, "cpu")
        W = tr.restrict_ if mode == "restrict" else tr.prolong
        n_out, n_in = W.dense.shape
        fmas = comps * int(torch.count_nonzero(W.dense)) * (
            n_in ** 2 + n_in * n_out + n_out ** 2)
    else:
        base = mode.partition("/")[0]
        fmas = PRODUCTS.get(base, PRODUCTS[name]) * (2 * p + 1) * N ** dim
    return roofline(nbytes, fmas, "mxu" in mode.partition("/")[2])


def roofline(nbytes: float, fmas: float, mxu: bool) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes at the HBM
    rate and the FMAs at the FP32 rate (the bf16 tensor-core rate for an
    ``mxu`` grade's products)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * fmas / (BF16_FLOPS if mxu else FP32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_modes(path, p, r, device) -> dict:
    """Each kernel mode against its twin (and its library yardstick) at one
    level shape, in float32, beside its bound and roofline share; the
    kernel's device time back to back is logged beside them."""
    times = {}
    for name, (mode, run, twin, lib, *_) in level_cases(path, p, r,
                                                        torch.float32, device):
        t_k, t_t = cuda_ms(run), cuda_ms(twin)
        t_l = cuda_ms(lib) if lib else None
        t_dev = device_ms(run)
        b_ms, by = bound(path, name, mode, p, r)
        times[(name, mode)] = dict(ms=t_k, plain_ms=t_t, library_ms=t_l,
                                   bound_ms=b_ms, bound_by=by)
        library = f"   library {t_l:8.3f} ms" if lib else ""
        log(f"  {name:10s} {mode:19s} kernel {t_k:8.3f} ms   twin {t_t:8.3f} ms"
            f"{library}   bound {b_ms:.4f} ms ({by}, "
            f"{100 * b_ms / t_k:.1f}% of roofline)   device {t_dev:.3f} ms "
            f"back to back")
    return times


def phase_second(device, r: int):
    """Phase 6: the 2D Q7 p-ladder in float64 on the plain path, then
    through the kernels in float64 and in float32."""
    log(f"phase 6: second path PolynomialMultigridPoisson(2, 7, {r}, 7)")
    # the plain path (Kronecker operator, plain Chebyshev and transfers on
    # full grids) gives the CG count the kernel path must reproduce
    prob = PolynomialMultigridPoisson(2, 7, r, 7, torch.float64, "kron", device)
    _, plain = prob.solve(rtol=1e-12)
    log(f"  float64, plain path (kron): CG iterations {plain.iterations}, "
        f"L2 {plain.solution_l2_norm!r}")
    del prob
    torch.cuda.empty_cache()
    runs = {}
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        name = str(dtype).split(".")[-1]
        t0 = time.perf_counter()
        prob = PolynomialMultigridPoisson(2, 7, r, 7, dtype, "auto", device)
        synchronize(device)
        t_setup = time.perf_counter() - t0
        reset_counts()
        x, st, per_mode = solve_both(prob, rtol, path_kernels("2d"),
                                     f"second path {name}")
        rel = abs(st.solution_l2_norm / MESH_L2_2D - 1.0)
        log(f"  {name}: setup {t_setup:.2f} s, CG iterations {st.iterations}, "
            f"residual {st.residual_norm:.3e}, L2 {st.solution_l2_norm!r} "
            f"(rel diff {rel:.2e} from {MESH_L2_2D}); launches {per_mode}")
        check_on_card(prob, x, device, per_mode, f"second path {name}")
        if dtype == torch.float32:
            check_grade(per_mode, "2d", f"second path {name}")
        runs[dtype] = prob, st, per_mode
    (p64, s64, _), (p32, s32, per_mode) = runs[torch.float64], runs[torch.float32]
    if not (s64.converged and s64.iterations == plain.iterations
            and s64.iterations <= MAX_CG_2D[torch.float64]):
        raise RuntimeError(f"second path float64: {s64.iterations} iterations, "
                           f"plain path {plain.iterations}")
    # the plain path sums K directly, which at r=9 leaves even float64
    # about 4e-10 of roundoff in the L2 norm (B.4 sums in difference form)
    if (abs(s64.solution_l2_norm / plain.solution_l2_norm - 1) > 1e-9
            or abs(s64.solution_l2_norm / MESH_L2_2D - 1) > 1e-7):
        raise RuntimeError("second path float64: L2 norm off")
    if not (s32.converged and s32.iterations <= MAX_CG_2D[torch.float32]):
        raise RuntimeError(f"second path float32: converged={s32.converged} "
                           f"in {s32.iterations} iterations")
    rel32 = abs(s32.solution_l2_norm / s64.solution_l2_norm - 1)
    log(f"  float32 L2 rel diff from float64: {rel32:.2e}")
    if rel32 > F32_L2_BOUND_2D:
        raise RuntimeError(f"second path float32: L2 norm off by {rel32:.2e}")
    del runs, p64
    torch.cuda.empty_cache()
    log("phase 6: ok")
    return p32, s32, per_mode


def device_busy(mg, rhs, wall: float, label: str = "",
                reps: int = 3) -> list:
    """torch.profiler over a few V-cycles: the device's own time per
    V-cycle against ``wall``, the V-cycle's ms timed without the profiler
    (which slows the host), and the kernels that take most of it; returns
    (ms, launches, name) per V-cycle of every kernel that took device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mg.apply(rhs)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            mg.apply(rhs)
        torch.cuda.synchronize()
    # the device's own events (kernels, copies, fills): no host-side row is
    # counted beside the kernel it launched
    per_name = collections.defaultdict(lambda: [0.0, 0])
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            per_name[ev.name][0] += ev.time_range.elapsed_us()
            per_name[ev.name][1] += 1
    rows = [(us / 1e3 / reps, n // reps, name)
            for name, (us, n) in per_name.items()]
    busy = sum(r[0] for r in rows)
    if busy == 0:
        log(f"  profiler ({label}): no device time recorded; busy share not "
            f"measured")
        return rows
    log(f"  profiler ({label}): {busy:.3f} ms device time per V-cycle of "
        f"{wall:.3f} ms: busy {100 * busy / wall:.1f}%")
    for ms, count, key in sorted(rows, reverse=True)[:8]:
        log(f"    {ms:9.3f} ms  {count:6d} x  {key[:90]}")
    return rows


def phase_second_timing(card: str, prob, st, device) -> dict:
    """Phase 7: 2D V-cycle, its split by level, CG solve and B.4 modes."""
    log(f"phase 7: timing on {card} (CUDA events, median of 10)")
    rhs = prob.rhs()
    n_dofs = prob.spaces[-1].n_dofs
    wall, rows = graph_report(card, prob, rhs, n_dofs, grade_vcycles(prob))
    log_levels(prob, rhs, lambda k, sp: f"p={sp.degree}")
    # by degree, over both instances (exact and bf16 state)
    b4 = collections.defaultdict(lambda: (0.0, 0))
    for ms, count, key in rows:
        m = re.search(r"laplace2d_kernel<float, (\d+)[,>]", key)
        if m:
            p = int(m.group(1))
            b4[p] = (b4[p][0] + ms, b4[p][1] + count)
    log(f"  profiler: B.4 {sum(v[0] for v in b4.values()):.3f} ms device time "
        f"per eager V-cycle of {wall['eager']:.3f} ms; by degree: " + ", ".join(
            f"p={p} {ms:.3f} ms / {n}" for p, (ms, n) in sorted(b4.items())))
    fine_op = prob.levels[-1].op
    mg = prob.preconditioner()
    t_solve = cuda_ms(lambda: cg(fine_op.apply, rhs, mg.apply, rtol=1e-5),
                      warmup=1)
    log(f"  CG solve to rtol 1e-5 ({st.iterations} iterations, graphed "
        f"V-cycle): {t_solve:.3f} ms = {n_dofs / (t_solve * 1e-3):.4e} DoF/s")
    times = time_modes("2d", *KERNELS["laplace2d"]["shape"], device)
    # every level of the ladder: its B.4 launches per V-cycle from the
    # profile and its busiest mode, cheb (the p = 1 coarse solve's too, at
    # 512^2), against the bound, so that launches x (ms - bound) reads for
    # the whole ladder
    r = KERNELS["laplace2d"]["shape"][1]
    gaps = 0.0
    for k, sp in enumerate(prob.spaces):
        p, mode = sp.degree, "cheb"
        run = next(c.run for _, c in level_cases("2d", p, r, torch.float32,
                                                 device) if c.mode == mode)
        t_k = device_ms(run)
        b_ms, by = bound("2d", "laplace2d", mode, p, r)
        ms_v, launches = b4.get(p, (0.0, 0))
        gaps += launches * (t_k - b_ms)
        log(f"  B.4 level p={p} ({2 ** r * p}^2): {launches} launches per "
            f"V-cycle, {1e3 * ms_v / max(launches, 1):.2f} us a launch in the "
            f"profile; {mode} {t_k:.4f} ms back to back, bound {b_ms:.4f} ms "
            f"({by}, {100 * b_ms / t_k:.1f}%); launches x gap "
            f"{launches * (t_k - b_ms):.3f} ms")
    log(f"  B.4 launches x (ms - bound) over the ladder: {gaps:.3f} ms per V-cycle")
    log("phase 7: ok")
    return times


def phase_elasticity_replay(device) -> None:
    """Phase 9: the pinned JAX elasticity counts and norms in float64
    through the kernels."""
    log("phase 9: elasticity replay, float64, variant auto")
    for (p, r), (iterations, l2) in ELASTICITY_F64.items():
        prob = ElasticityMultigrid(3, p, r, dtype=torch.float64,
                                   variant="auto", device=device)
        _, st = prob.solve()
        rel = abs(st.solution_l2_norm / l2 - 1.0)
        log(f"  ElasticityMultigrid(3, {p}, {r}): {st.iterations} iterations "
            f"(JAX {iterations}), L2 rel diff {rel:.2e}")
        if not st.converged or st.iterations != iterations or rel > 1e-10:
            raise RuntimeError(f"elasticity ({p}, {r}) does not match the "
                               f"JAX package")
    log("phase 9: ok")


def phase_elasticity(device, r: int):
    """Phase 10: the 3D Q3 elasticity solve at full width: float64 on the
    plain path, then through the kernels in float64 and in float32."""
    log(f"phase 10: third path ElasticityMultigrid(3, 3, {r})")
    prob = ElasticityMultigrid(3, 3, r, dtype=torch.float64, variant="kron",
                               device=device)
    t0 = time.perf_counter()
    _, plain = prob.solve(rtol=1e-12)
    synchronize(device)
    log(f"  float64, plain path (kron): CG iterations {plain.iterations}, "
        f"L2 {plain.solution_l2_norm!r} ({time.perf_counter() - t0:.1f} s)")
    del prob
    torch.cuda.empty_cache()
    runs = {}
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        name = str(dtype).split(".")[-1]
        t0 = time.perf_counter()
        prob = ElasticityMultigrid(3, 3, r, dtype=dtype, variant="auto",
                                   device=device)
        synchronize(device)
        t_setup = time.perf_counter() - t0
        reset_counts()
        x, st, per_mode = solve_both(prob, rtol, ("elasticity", "transfer"),
                                     f"third path {name}")
        log(f"  {name}: setup {t_setup:.2f} s, CG iterations "
            f"{st.iterations}, residual {st.residual_norm:.3e}, "
            f"L2 {st.solution_l2_norm!r}; launches {per_mode}")
        check_on_card(prob, x, device, per_mode, f"third path {name}")
        if dtype == torch.float32:
            # the JAX package's smoother grade: B.5's mxu core
            check_grade(per_mode, "elasticity", f"third path {name}")
        runs[dtype] = prob, st, per_mode
        del x
    (p64, s64, _), (p32, s32, per_mode) = runs[torch.float64], runs[torch.float32]
    if not (s64.converged and s64.iterations == plain.iterations):
        raise RuntimeError(f"third path float64: {s64.iterations} iterations, "
                           f"plain path {plain.iterations}")
    rel64 = abs(s64.solution_l2_norm / plain.solution_l2_norm - 1)
    log(f"  float64 L2 rel diff, B.5 vs plain path: {rel64:.2e}")
    if rel64 > 1e-9:
        raise RuntimeError(f"third path float64: L2 norm off by {rel64:.2e}")
    if not s32.converged:
        raise RuntimeError(f"third path float32: not converged in "
                           f"{s32.iterations} iterations")
    rel32 = abs(s32.solution_l2_norm / s64.solution_l2_norm - 1)
    log(f"  float32 L2 rel diff from float64: {rel32:.2e}")
    if rel32 > F32_L2_BOUND_ELASTICITY:
        raise RuntimeError(f"third path float32: L2 norm off by {rel32:.2e}")
    # the mxu grade may not cost a CG iteration over the exact grade
    rhs = p32.rhs()
    exact = cg(p32.fine_operator.apply, rhs,
               grade_vcycle(p32, exact=True).apply, rtol=1e-5).iterations
    log(f"  float32 CG iterations: {s32.iterations} at the mxu grade, "
        f"{exact} at the exact grade")
    if s32.iterations > exact:
        raise RuntimeError(f"third path float32: {s32.iterations} CG "
                           f"iterations at the mxu grade, {exact} exact")
    del rhs
    del runs, p64
    torch.cuda.empty_cache()
    log("phase 10: ok")
    return p32, s32, per_mode


def phase_elasticity_timing(card: str, prob, st, device) -> dict:
    """Phase 11: elasticity V-cycle at the mxu grade (the default) and at
    the exact grade, its split by level, the busy share, the CG solve and
    each B.5 mode (both cores) against its twin at 3 x 192^3."""
    log(f"phase 11: timing on {card} (CUDA events, median of 10)")
    rhs = prob.rhs()
    n_dofs = prob.levels[-1].op.n_dofs
    graph_report(card, prob, rhs, n_dofs, grade_vcycles(prob))
    log_levels(prob, rhs)
    fine_op = prob.levels[-1].op
    mg = prob.preconditioner()
    t_solve = cuda_ms(lambda: cg(fine_op.apply, rhs, mg.apply, rtol=1e-5),
                      warmup=1)
    log(f"  CG solve to rtol 1e-5 ({st.iterations} iterations, graphed "
        f"V-cycle): {t_solve:.3f} ms = {n_dofs / (t_solve * 1e-3):.4e} DoF/s")
    times = time_modes("elasticity", *KERNELS["elasticity"]["shape"], device)
    for mode in ("cheb", "chebl"):
        t, ex = times[("elasticity", mode + "/mxu")], times[("elasticity",
                                                             mode)]
        log(f"  elasticity {mode}/mxu {t['ms']:.3f} ms vs the exact "
            f"{mode} {ex['ms']:.3f} ms ({t['ms'] / ex['ms']:.2f}x), bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})")
    check_elasticity_on_tensor_cores(prob, rhs, "third path float32")
    log("phase 11: ok")
    # B.3's times are reported at the main path's shape (phase 5)
    return {k: v for k, v in times.items() if k[0] == "elasticity"}


def solve_ms(prob, rtol: float) -> float:
    """Median ms of 3 CG solves of a model from its rhs, through its
    graphed V-cycle (captured before the timing)."""
    rhs, mg, op = prob.rhs(), prob.preconditioner(), prob.fine_operator
    return cuda_ms(lambda: cg(op.apply, rhs, mg.apply, rtol=rtol), reps=3,
                   warmup=1)


def phase_mixed(card: str, device, r: int) -> None:
    """Phase 12: config 3, the p -> h ladder, at full width."""
    log(f"phase 12: config 3 MixedMultigridPoisson(3, {r}, {LADDER_3}) on "
        f"{card}")
    reset_counts()
    t0 = time.perf_counter()
    prob = MixedMultigridPoisson(3, r, LADDER_3, torch.float32, "auto", device)
    synchronize(device)
    t_setup = time.perf_counter() - t0
    x, st, per_mode = solve_both(prob, 1e-5, path_kernels("3d"),
                                 "config 3 float32")
    l2_rel = abs(st.solution_l2_norm / GOLDEN_L2_Q4_R6 - 1.0)
    log(f"  float32: setup {t_setup:.2f} s, {len(prob.levels)} levels "
        f"{st.dofs_per_level} DoFs, CG iterations {st.iterations}, residual "
        f"{st.residual_norm:.3e}, L2 {st.solution_l2_norm:.10f} (rel diff "
        f"{l2_rel:.2e} from {GOLDEN_L2_Q4_R6}); launches {per_mode}")
    if not st.converged or l2_rel > F32_L2_BOUND_3D:
        raise RuntimeError(f"config 3 float32: converged={st.converged}, L2 "
                           f"off by {l2_rel:.2e}")
    check_on_card(prob, x, device, per_mode, "config 3 float32")
    check_grade(per_mode, "3d", "config 3 float32")
    del x
    rhs = prob.rhs()
    graph_report(card, prob, rhs, st.n_dofs, grade_vcycles(prob))
    log_levels(prob, rhs, lambda k, sp: f"p={sp.degree} "
               f"{sp.mesh.cells_per_axis}^3 cells")
    log(f"  CG solve to rtol 1e-5 ({st.iterations} iterations, graphed "
        f"V-cycle): {solve_ms(prob, 1e-5):.3f} ms [{card}]")
    del prob, rhs
    torch.cuda.empty_cache()
    f64 = {}
    for variant in ("auto", "kron"):
        t0 = time.perf_counter()
        prob = MixedMultigridPoisson(3, r, LADDER_3, torch.float64, variant,
                                     device)
        _, f64[variant] = prob.solve(rtol=1e-12)
        synchronize(device)
        log(f"  float64 {variant}: CG iterations {f64[variant].iterations}, "
            f"L2 {f64[variant].solution_l2_norm!r} (setup and solve "
            f"{time.perf_counter() - t0:.1f} s)")
        del prob
        torch.cuda.empty_cache()
    rel = abs(f64["auto"].solution_l2_norm / f64["kron"].solution_l2_norm - 1)
    log(f"  float64 L2 rel diff, kernels vs kron: {rel:.2e}")
    if not (f64["auto"].converged
            and f64["auto"].iterations == f64["kron"].iterations
            and rel <= 1e-9):
        raise RuntimeError(f"config 3 float64: {f64['auto'].iterations} "
                           f"iterations through the kernels, "
                           f"{f64['kron'].iterations} on kron, L2 off by "
                           f"{rel:.2e}")
    log("phase 12: ok")


def phase_mixed_precision(card: str, device, r: int) -> None:
    """Phase 13: config 5, the float32 V-cycle under float64 CG, and
    iterative refinement, at full width."""
    log(f"phase 13: config 5 MixedPrecisionPoisson(3, 4, {r}, float32) on "
        f"{card}")
    prob64 = GeometricMultigridPoisson(3, 4, r, torch.float64, "auto", device)
    x64, s64 = prob64.solve(rtol=1e-12)
    t64 = solve_ms(prob64, 1e-12)
    log(f"  float64 GeometricMultigridPoisson: CG iterations {s64.iterations}, "
        f"L2 {s64.solution_l2_norm!r}; solve {t64:.3f} ms [{card}]")
    del prob64
    torch.cuda.empty_cache()
    mixed = MixedPrecisionPoisson(3, 4, r, torch.float32, "auto", device)
    reset_counts()
    xm, sm = mixed.solve(rtol=1e-12)
    synchronize(device)
    counts = {k: dict(KERNELS[k]["counts"]) for k in path_kernels("3d")}
    check_on_card(mixed, xm, device, counts, "config 5")
    check_grade(counts, "3d", "config 5")
    tm = solve_ms(mixed, 1e-12)
    rel = abs(sm.solution_l2_norm / s64.solution_l2_norm - 1)
    log(f"  mixed precision: CG iterations {sm.iterations}, L2 "
        f"{sm.solution_l2_norm!r} (rel diff {rel:.2e} from float64); solve "
        f"{tm:.3f} ms [{card}]")
    if not (sm.converged and abs(sm.iterations - s64.iterations) <= 2
            and rel <= 1e-9):
        raise RuntimeError(f"config 5: {sm.iterations} iterations against "
                           f"{s64.iterations} in float64, L2 off by {rel:.2e}")
    graph_report(card, mixed, mixed.rhs(), sm.n_dofs, grade_vcycles(mixed))
    del xm
    # refinement: float32 CG to 1e-6 on B.1 with the graphed float32
    # V-cycle inside, B.1's float64 apply outside
    op32, op64 = mixed.levels[-1].op, mixed.fine_op64
    mg32 = GraphedVCycle(VCycle(levels=mixed.levels,
                                fine_trimmed=mixed.fine_trimmed))
    inner_its = []

    def inner(r32):
        res = cg(op32.apply, r32, mg32.apply, rtol=1e-6)
        inner_its.append(res.iterations)
        return res.x

    b = mixed.rhs()
    x, cycles, res = iterative_refinement(op64.apply, inner, b, rtol=1e-12)
    synchronize(device)
    its = list(inner_its)
    t_ref = cuda_ms(lambda: iterative_refinement(op64.apply, inner, b,
                                                 rtol=1e-12), reps=3, warmup=1)
    bnorm = float(torch.linalg.vector_norm(b))
    err = rel_err(x, x64)[1]
    log(f"  iterative refinement: {cycles} cycles (inner CG iterations "
        f"{its}), residual {res:.3e} = {res / bnorm:.2e} ||b||, x "
        f"{err:.2e} max|x| from the float64 solve; solve {t_ref:.3f} ms "
        f"[{card}]")
    if not (cycles <= 5 and res <= 1e-12 * bnorm and err <= 1e-10):
        raise RuntimeError(f"refinement: {cycles} cycles, residual "
                           f"{res / bnorm:.2e} ||b||, x off by {err:.2e}")
    log("phase 13: ok")


def total_launches() -> int:
    """Launches of every kernel since the last ``reset_counts``."""
    return sum(sum(k["counts"].values()) for k in KERNELS.values())


def varcoef_model(variant: str, r: int, dtype, device):
    """GeometricMultigridPoisson(3, 4, r, coefficient=c) on one
    PMG_VARCOEFF_VARIANT, and its setup seconds."""
    old = os.environ.get("PMG_VARCOEFF_VARIANT")
    os.environ["PMG_VARCOEFF_VARIANT"] = variant
    try:
        t0 = time.perf_counter()
        prob = GeometricMultigridPoisson(3, 4, r, dtype, "auto", device,
                                         coefficient=coefficient)
        synchronize(device)
        return prob, time.perf_counter() - t0
    finally:
        if old is None:
            del os.environ["PMG_VARCOEFF_VARIANT"]
        else:
            os.environ["PMG_VARCOEFF_VARIANT"] = old


def solve_graphed(prob, rtol: float, what: str):
    """The model's solve, through its graphed V-cycle, on the card."""
    t0 = time.perf_counter()
    x, st = prob.solve(rtol=rtol)
    synchronize(prob.device)
    log(f"  {what}: graphed solve {st.iterations} CG iterations in "
        f"{time.perf_counter() - t0:.2f} s")
    if not prob.preconditioner()._graphs:
        raise RuntimeError(f"{what}: the solve ran no graphed V-cycle")
    check_on_card(prob, x, prob.device, {}, what)
    return st


def apply_ms(prob) -> float:
    """Device ms of one fine-level operator apply, back to back."""
    op = prob.fine_operator
    u = torch.ones(op.shape, dtype=op.dtype, device=op.device)
    return device_ms(lambda: op.apply(u))


# V-cycles of 0.03-0.4 s are timed by the median of 3 after 1 warm-up
SLOW_REPS = dict(reps=3, warmup=1)


def vcycle_turns(card: str, prob, n_dofs: int, what: str) -> None:
    """The eager and the graphed V-cycle of a model in turns: ms, DoF/s."""
    runs = time_turns({"eager": prob.preconditioner(graph=False),
                       "graphed": prob.preconditioner()}, prob.rhs(),
                      **SLOW_REPS)
    for name, ts in runs.items():
        log(f"  {what} V-cycle {name:7s}: {ts[0]:.3f} / {ts[1]:.3f} ms = "
            f"{n_dofs / (min(ts) * 1e-3):.4e} DoF/s ({n_dofs} DoFs) [{card}]")


def phase_varcoef(card: str, device, r: int) -> None:
    """Phase 14: config 4's variable-coefficient solve at full width."""
    log(f"phase 14: variable coefficient GeometricMultigridPoisson(3, 4, {r}, "
        f"coefficient=c) on {card}")
    for variant, (iterations, l2) in VARCOEF_F64_R3.items():
        prob, _ = varcoef_model(variant, 3, torch.float64, device)
        _, st = prob.solve()
        rel = abs(st.solution_l2_norm / l2 - 1.0)
        log(f"  float64 {variant} r=3: {st.iterations} iterations (JAX "
            f"{iterations}), L2 {st.solution_l2_norm!r}, rel diff {rel:.2e}")
        if not st.converged or st.iterations != iterations or rel > 1e-10:
            raise RuntimeError(f"variable coefficient {variant} r=3 does not "
                               f"match the JAX package")
    solves = {}
    for dtype, rtol, variants in ((torch.float64, 1e-12, ("qdense", "sumfac")),
                                  (torch.float32, 1e-5,
                                   ("qdense", "sumfac", "qbanded"))):
        name = str(dtype).split(".")[-1]
        for variant in variants:
            what = f"{variant} {name}"
            reset_counts()
            prob, t_setup = varcoef_model(variant, r, dtype, device)
            if (variant, dtype) == ("qdense", torch.float32):
                x, st, _ = solve_both(prob, rtol, (), what)
                check_on_card(prob, x, device, {}, what)
                del x
            else:
                st = solve_graphed(prob, rtol, what)
            # construction, and the graphed solve's warm-up, capture and
            # CG operator
            if total_launches():
                raise RuntimeError(f"{what}: {total_launches()} kernel "
                                   f"launches on a path of plain operators")
            log(f"  {what}: setup {t_setup:.2f} s, CG iterations "
                f"{st.iterations}, residual {st.residual_norm:.3e}, L2 "
                f"{st.solution_l2_norm!r}; one apply {apply_ms(prob):.3f} ms "
                f"device time; kernel launches 0 [{card}]")
            solves[(variant, dtype)] = st
            if (variant, dtype) == ("qdense", torch.float32):
                rhs = prob.rhs()
                log(f"  {what} V-cycle:")
                graph_report(card, prob, rhs, st.n_dofs, **SLOW_REPS)
                log_levels(prob, rhs)
                del rhs
            elif dtype == torch.float32:
                vcycle_turns(card, prob, st.n_dofs, what)
            del prob
            torch.cuda.empty_cache()
    q64, s64 = solves[("qdense", torch.float64)], solves[("sumfac",
                                                          torch.float64)]
    rel = abs(s64.solution_l2_norm / q64.solution_l2_norm - 1)
    log(f"  float64 qdense vs sumfac: {q64.iterations} / {s64.iterations} CG "
        f"iterations, L2 rel diff {rel:.2e}")
    if not (q64.converged and s64.converged
            and q64.iterations == s64.iterations and rel <= 1e-10):
        raise RuntimeError("variable coefficient float64: qdense and sumfac "
                           "disagree")
    for variant in ("qdense", "sumfac", "qbanded"):
        st = solves[(variant, torch.float32)]
        rel = abs(st.solution_l2_norm / q64.solution_l2_norm - 1)
        log(f"  float32 {variant}: L2 rel diff from float64 {rel:.2e}")
        if not st.converged or rel > 1e-5:
            raise RuntimeError(f"variable coefficient float32 {variant}: "
                               f"converged={st.converged}, L2 off by {rel:.2e}")
    log("phase 14: ok")


def phase_variants(card: str, device, r: int, r_elasticity: int) -> None:
    """Phase 15: the constant-coefficient variants sumfac and dense."""
    log(f"phase 15: operator variants sumfac and dense on {card}")
    for variant in ("sumfac", "dense"):
        what = f"GeometricMultigridPoisson(3, 4, {r}) {variant} float32"
        t0 = time.perf_counter()
        prob = GeometricMultigridPoisson(3, 4, r, torch.float32, variant,
                                         device)
        synchronize(device)
        t_setup = time.perf_counter() - t0
        st = solve_graphed(prob, 1e-5, what)
        l2_rel = abs(st.solution_l2_norm / GOLDEN_L2_Q4_R6 - 1.0)
        log(f"  {what}: setup {t_setup:.2f} s, CG iterations "
            f"{st.iterations}, L2 {st.solution_l2_norm:.10f} (rel diff "
            f"{l2_rel:.2e} from {GOLDEN_L2_Q4_R6}); one apply "
            f"{apply_ms(prob):.3f} ms device time [{card}]")
        if not (st.converged and st.iterations <= 4
                and l2_rel <= F32_L2_BOUND_3D):
            raise RuntimeError(f"{what}: {st.iterations} iterations, L2 off "
                               f"by {l2_rel:.2e}")
        vcycle_turns(card, prob, st.n_dofs, variant)
        del prob
        torch.cuda.empty_cache()
    what = f"config 3 MixedMultigridPoisson(3, {r}, {LADDER_3}) sumfac float32"
    prob = MixedMultigridPoisson(3, r, LADDER_3, torch.float32, "sumfac",
                                 device)
    st = solve_graphed(prob, 1e-5, what)
    l2_rel = abs(st.solution_l2_norm / GOLDEN_L2_Q4_R6 - 1.0)
    log(f"  {what}: CG iterations {st.iterations}, L2 "
        f"{st.solution_l2_norm:.10f} (rel diff {l2_rel:.2e})")
    if not st.converged or l2_rel > F32_L2_BOUND_3D:
        raise RuntimeError(f"{what}: L2 off by {l2_rel:.2e}")
    vcycle_turns(card, prob, st.n_dofs, "config 3 sumfac")
    del prob
    torch.cuda.empty_cache()
    runs = {}
    for variant in ("kron", "sumfac", "dense"):
        what = (f"ElasticityMultigrid(3, 3, {r_elasticity}) {variant} "
                f"float64")
        prob = ElasticityMultigrid(3, 3, r_elasticity, dtype=torch.float64,
                                   variant=variant, device=device)
        runs[variant] = st = solve_graphed(prob, 1e-12, what)
        log(f"  {what}: CG iterations {st.iterations}, L2 "
            f"{st.solution_l2_norm!r}")
        vcycle_turns(card, prob, st.n_dofs, f"elasticity {variant}")
        del prob
        torch.cuda.empty_cache()
    kron = runs["kron"]
    for variant in ("sumfac", "dense"):
        st = runs[variant]
        rel = abs(st.solution_l2_norm / kron.solution_l2_norm - 1)
        log(f"  elasticity float64 {variant} vs kron: {st.iterations} / "
            f"{kron.iterations} CG iterations, L2 rel diff {rel:.2e}")
        if not (st.converged and st.iterations == kron.iterations
                and rel <= 1e-9):
            raise RuntimeError(f"elasticity {variant}: {st.iterations} "
                               f"iterations, kron {kron.iterations}, L2 off "
                               f"by {rel:.2e}")
    log("phase 15: ok")


# --------------------------------------------------------------------------
# phase 16: the slab-sharded solve, S shards on one card
# --------------------------------------------------------------------------

SHARDS = 4  # the sharded main path's shards on one card
# the modes of phase 16's kernels at the Q4 r=6 slab (launch keys)
SLAB_KEYS = ("apply/slab", "residual1f/slab", "residual3f/slab",
             "chebf/slab")
PAIR_MODES = ("cheb2", "cheb2l", "chebd2", "chebd2l", "cheb2f0", "cheb2f0l")


def global_fields(op, rng, dtype, device, k: int = 3) -> list:
    """k random trimmed fields of the global grid, zero on constrained
    entries."""
    return [masked_trimmed(op, rng, dtype, device) for _ in range(k)]


def halo(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Planes lo .. hi - 1 of a trimmed global field, zeros off the grid."""
    N = t.shape[0]
    out = t.new_zeros((hi - lo,) + t.shape[1:])
    a, b = max(lo, 0), min(hi, N)
    out[a - lo: b - lo] = t[a:b]
    return out


def sharded_cases(p: int, r: int, S: int, s: int, device):
    """(kernel, :class:`Case`, single) for every mode of B.1's slab
    instance (exact and mxu core) and of B.2's xext pair (exact and
    production grade, float32 state) on shard s of S at (p, r), float32:
    random global fields, the shard's inputs cut from them; ``single`` the
    single-device kernel's outputs at the shard's planes (the pair: its
    outputs there must be the same bit for bit), else None."""
    dtype = torch.float32
    sp = space(p, r)
    devices = [device] * S
    rng = np.random.default_rng(s)
    cube = cuda_laplace.make_cuda_laplace(sp, dtype, device)
    u, rhs, x = global_fields(cube, rng, dtype, device)
    slabs = {core: _build_stacked_slab(sp, devices, dtype, core).local[s]
             for core in ("banded", "mxu")}
    L = slabs["banded"].trimmed_shape[0]
    lo, hi = s * L, (s + 1) * L
    u_ext = halo(u, lo, hi + 1)
    ins = {"apply": ((), ()), "residual1f": ((rhs[lo:hi],), ()),
           "residual3f": ((rhs[lo:hi],), SCAL_RES3),
           "chebf": ((rhs[lo:hi], x[lo:hi]), SCAL_CHEB)}
    for core, op in slabs.items():
        for mode, (i, sc) in ins.items():
            key = mode + "/slab" + ("/mxu" if core == "mxu" else "")
            if core == "mxu":
                yield "laplace", bf16_case(key, op, mode, u_ext, i, sc), None
                continue
            yield "laplace", Case(
                key, lambda o=op, m=mode, i=i, sc=sc: o.run(m, u_ext, i, sc),
                lambda o=op, m=mode, i=i, sc=sc: o.twin(m, u_ext, i, sc)), \
                None
    if _build_stacked_cheb2(sp, devices, dtype) is None:
        return  # one-cell slabs: the smoother takes single steps
    for core in ("banded", "mxu"):
        op = cube if core == "banded" else cuda_laplace.make_cuda_laplace(
            sp, dtype, device, core="mxu")
        kern = cuda_cheb2.make_cheb2_xext(op, lo, L)
        whole = cuda_cheb2.make_cheb2(op)
        d, rr = halo(u, lo - 2 * p, hi + 2 * p), halo(rhs, lo - p, hi + p)
        for mode in PAIR_MODES:
            f0 = mode.startswith("cheb2f0")
            has_x = mode in ("cheb2", "cheb2l")
            a = (d, None if f0 else rr, x[lo:hi] if has_x else None,
                 SCAL_PAIR_F0 if f0 else SCAL_PAIR)
            g = (u, None if f0 else rhs, x if has_x else None, a[3])
            key = cuda_laplace.launch_key(mode + "/xext", op.core, None)
            yield "cheb2", Case(
                key, lambda k=kern, a=a, m=mode: k.steps2(*a, m),
                lambda o=op, a=a, m=mode: cuda_cheb2.cheb2_twin_xext(
                    o, lo, L, *a, m),
                mags=(lambda o=op, g=g, m=mode: tuple(
                    t[lo:hi] for t in pair_magnitudes(o, *g, m)))
                if core == "mxu" else None), \
                (lambda w=whole, g=g, m=mode: tuple(
                    t[lo:hi] for t in w.steps2(*g, m)))


def sharded_compare(p: int, r: int, S, shards, device, errs,
                    cases=None) -> dict:
    """Each mode of :func:`sharded_cases` (or of ``cases``, called as it
    is, with S the mesh) against its twin on the given shards: the exact
    modes within BOUND, B.1's mxu core and B.2's production grade point
    by point (:func:`flip_check`; B.1 within BF16_BOUND too); every pair
    output also against the single-device pair's.  Returns the number of
    pair outputs equal to the single-device pair's bit for bit, by grade,
    and of those compared."""
    same = collections.Counter()
    for s in shards:
        for name, c, single in (cases or sharded_cases)(p, r, S, s, device):
            got, want = c.run(), c.twin()
            synchronize(device)
            worst = 0.0
            for g, w in zip(got, want):
                if not torch.isfinite(g).all() or g.shape != w.shape:
                    raise RuntimeError(f"{name}/{c.mode} p={p} r={r} shard "
                                       f"{s}/{S}: non-finite or shape "
                                       f"{tuple(g.shape)}")
                err, rel = rel_err(g, w)
                worst = max(worst, rel)
                key = (name, c.mode, p, r, "float32")
                errs[key] = max(errs.get(key, 0.0), err)
            head = f"  {name:8s} {c.mode:22s} p={p} r={r} shard {s}/{S}"
            if c.mags is not None:
                seen, ok = flip_check(name, c, got, want, worst)
            else:
                bound = BF16_BOUND if "mxu" in c.mode else BOUND[torch.float32]
                seen = f"max rel err {worst:.3e} (bound {bound:.0e})"
                ok = worst <= bound
            if single is not None:
                ref = single()
                synchronize(device)
                grade = "mxu" if "mxu" in c.mode else "exact"
                same[grade, "outputs"] += len(got)
                same[grade, "bitwise"] += sum(bool(torch.equal(g, w))
                                              for g, w in zip(got, ref))
                diff = max(rel_err(g, w)[1] for g, w in zip(got, ref))
                seen += f"; vs the single-device pair {diff:.3e}"
                ok = ok and diff <= (BF16_BOUND if grade == "mxu"
                                     else BOUND[torch.float32])
            log(f"{head} {seen}")
            if not ok:
                raise RuntimeError(f"{name}/{c.mode} p={p} r={r} shard "
                                   f"{s}/{S}: {seen}")
    return same


def time_sharded_modes(p: int, r: int, S, device, s: int = 1,
                       pencil: bool = False) -> dict:
    """Each phase 16 mode on shard s of S at (p, r) (``pencil``: each
    phase 17 mode on pencil s of the mesh S), in float32: kernel and twin
    ms (CUDA events, median of 10), the bound from the bytes of this
    call's inputs and outputs and the FMAs of its stencil applications on
    the shard's output points."""
    times = {}
    hy = int(pencil)  # a pencil's inputs extend y as a slab's extend x
    for name, c, _ in (pencil_cases if pencil else sharded_cases)(
            p, r, S, s, device):
        outs = c.run()
        t_k, t_t = cuda_ms(c.run), cuda_ms(c.twin)
        Lx, Ly, N = outs[0].shape

        def points(h):  # a march's points with h planes (and rows) a side
            return (Lx + 2 * h) * (Ly + 2 * h * hy)

        # the inputs: B.1's u with the shared plane (and row), and its
        # epilogue inputs; d and r with 2p and p planes (and rows) of halo
        # (b alone with 2p for cheb2f0) and x for a pair
        base = c.mode.partition("/")[0]
        if name == "laplace":
            points_in = (Lx + 1) * (Ly + hy) + Lx * Ly * {
                "apply": 0, "residual1f": 1, "residual3f": 1,
                "chebf": 2}[base]
            products = PRODUCTS["laplace"]
        else:
            points_in = (points(2 * p)
                         + (0 if base.startswith("cheb2f0") else points(p))
                         + (Lx * Ly if base in ("cheb2", "cheb2l") else 0))
            products = PRODUCTS["cheb2"]
        nbytes = 4 * N * (points_in + Lx * Ly * len(outs))
        b_ms, by = roofline(nbytes, products * (2 * p + 1) * Lx * Ly * N,
                            "mxu" in c.mode)
        times[(name, c.mode)] = dict(ms=t_k, plain_ms=t_t, library_ms=None,
                                     bound_ms=b_ms, bound_by=by)
        log(f"  {name:8s} {c.mode:22s} kernel {t_k:8.3f} ms   twin "
            f"{t_t:8.3f} ms   bound {b_ms:.4f} ms ({by}, "
            f"{100 * b_ms / t_k:.1f}% of roofline)   device "
            f"{device_ms(c.run):.3f} ms back to back")
    return times


def f32_state_vcycle(prob) -> VCycle:
    """The single-device model's V-cycle at the sharded solve's grade:
    the mxu recurrence and B.2's production pairs at float32 state (the
    smoothers' state dtype dropped, nothing else changed)."""
    def change(sm):
        if isinstance(sm, FusedChebyshev) and sm.state_dtype is not None:
            return dataclasses.replace(sm, state_dtype=None)
        return sm

    levels = tuple(dataclasses.replace(lvl, smoother=change(lvl.smoother))
                   for lvl in prob.levels)
    return VCycle(levels=levels, fine_trimmed=prob.fine_trimmed)


def sharded_launches(tags=("/slab", "/xext")) -> dict:
    """The phase 16 kernels' launches by key since the last reset (phase
    17's with ``tags`` ("/pencil",))."""
    return {name: {k: n for k, n in KERNELS[name]["counts"].items()
                   if n and any(t in k for t in tags)}
            for name in ("laplace", "cheb2")}


def sharded_solve(card: str, devices, p: int, r: int, what: str,
                  timing: bool = False, mesh: tuple | None = None):
    """The kernel path's sharded solve (``mesh`` (sx, sy): the pencil
    solve) against the single-device one at the same grade, in float32 to
    rtol 1e-5: converged, the same CG count, x within SHARD_X_BOUND of
    max |x|; returns (stats, the launches of the solve by kernel and key,
    times).  With ``timing`` its eager V-cycle in turns with the single
    device's, eager and graphed, and for a pencil solve with the slab
    solve's over as many shards."""
    device = devices[0]
    tags = ("/slab", "/xext") if mesh is None else ("/pencil",)
    label = "sharded eager" if mesh is None else "pencil eager"
    reset_counts()
    t0 = time.perf_counter()
    if mesh is None:
        prob = ShardedGeometricPoisson(3, p, r, devices=devices,
                                       dtype=torch.float32, variant="auto")
    else:
        prob = Sharded2DGeometricPoisson(3, p, r, mesh, devices=devices,
                                         dtype=torch.float32, variant="auto")
    synchronize(device)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, st = prob.solve(rtol=1e-5, verbose=True)
    synchronize(device)
    t_solve = time.perf_counter() - t0
    launches = sharded_launches(tags)
    log(f"  {what}: setup {t_setup:.2f} s, solve {t_solve:.2f} s; launches "
        f"(construction and solve) {launches}")
    for name in ("laplace", "cheb2"):
        if not launches[name]:
            raise RuntimeError(f"{what} never launched the sharded modes of "
                               f"{name}")
    single = GeometricMultigridPoisson(3, p, r, torch.float32, "auto",
                                       device)
    v1 = f32_state_vcycle(single)
    rhs1 = single.rhs()
    res1 = cg(single.fine_operator.apply, rhs1, v1.apply, rtol=1e-5)
    x1 = res1.x.cpu().numpy()
    diff = float(np.abs(x - x1).max() / np.abs(x1).max())
    log(f"  {what}: {st.iterations} CG iterations (single device, float32 "
        f"state: {res1.iterations}), L2 {st.solution_l2_norm:.10f}, x "
        f"within {diff:.3e} of max |x| of the single-device x")
    if not (st.converged and st.iterations == res1.iterations
            and diff <= SHARD_X_BOUND):
        raise RuntimeError(f"{what}: converged={st.converged}, "
                           f"{st.iterations} CG iterations against "
                           f"{res1.iterations}, x off by {diff:.3e}")
    times = {}
    if timing:
        rhs = prob.rhs()
        mg = prob.preconditioner()
        vcycles = {label: mg, "single eager": v1,
                   "single graphed": GraphedVCycle(v1)}
        srcs = {label: rhs, "single eager": rhs1, "single graphed": rhs1}
        if mesh is not None:
            slab = ShardedGeometricPoisson(3, p, r, devices=devices,
                                           dtype=torch.float32,
                                           variant="auto")
            vcycles["slab eager"] = slab.preconditioner()
            srcs["slab eager"] = slab.rhs()
        turns = time_turns(vcycles, srcs)
        n_dofs = st.n_dofs
        for name, ts in turns.items():
            log(f"  V-cycle {name:15s} (float32 state): {ts[0]:.3f} / "
                f"{ts[1]:.3f} ms = {n_dofs / (min(ts) * 1e-3):.4e} DoF/s "
                f"[{card}]")
        device_busy(mg, rhs, statistics.mean(turns[label]), label)
        device_busy(v1, rhs1, statistics.mean(turns["single eager"]),
                    "single eager")
        reset_counts()
        mg.apply(rhs)
        synchronize(device)
        log(f"  launches per {label[:-6]} V-cycle: {sharded_launches(tags)}")
        reset_counts()
        times = turns
    return st, launches, times


# the keys phase 16's sharded main path must launch: B.1's slab modes
# (apply for CG, residual3f and residual1f on the exact core, chebf on the
# mxu core, the single steps of the one-cell slabs of r = 2) and B.2's
# xext pairs at the production grade
SHARDED_KEYS = {"laplace": SLAB_KEYS[:3] + ("chebf/slab/mxu",),
                "cheb2": ("cheb2/xext/mxu", "cheb2l/xext/mxu",
                          "cheb2f0/xext/mxu")}
# the sharded solve's x against the single-device one's, over max |x|
SHARD_X_BOUND = 1e-5


def phase_sharded(card: str, device, errs: dict, per_mode: dict) -> dict:
    """Phase 16: the slab-sharded solve as S shards on one card."""
    log(f"phase 16: slab-sharded solve, {SHARDS} shards on one card "
        f"({card})")
    same = collections.Counter()
    for p in range(1, 8):
        same.update(sharded_compare(p, 3, SHARDS, (0, 1, SHARDS - 1),
                                    device, errs))
    # the fine slab of the main path: 16 cells, 65 x 256 x 256 points in
    same.update(sharded_compare(4, 6, SHARDS, (1,), device, errs))
    for grade in ("exact", "mxu"):
        log(f"  B.2 xext at the {grade} grade: {same[grade, 'bitwise']} of "
            f"{same[grade, 'outputs']} outputs equal to the single-device "
            f"pair's bit for bit")
    times = time_sharded_modes(4, 6, SHARDS, device, 1)
    st, launches, _ = sharded_solve(card, [device] * SHARDS, 4, 6,
                                    f"ShardedGeometricPoisson(3, 4, 6, "
                                    f"{SHARDS} shards, float32, auto)",
                                    timing=True)
    l2_rel = abs(st.solution_l2_norm / GOLDEN_L2_Q4_R6 - 1.0)
    log(f"  L2 {st.solution_l2_norm:.10f}, rel diff {l2_rel:.2e} from the "
        f"golden {GOLDEN_L2_Q4_R6}")
    if l2_rel > F32_L2_BOUND_3D:
        raise RuntimeError(f"sharded main path L2 off by {l2_rel:.2e}")
    for name, keys in SHARDED_KEYS.items():
        missing = [k for k in keys if not launches[name].get(k)]
        if missing:
            raise RuntimeError(f"sharded main path: {name} never launched "
                               f"{missing}")
        per_mode[name].update(launches[name])
    # the halo edge: two-cell slabs (and one-cell ones at r = 3)
    sharded_solve(card, [device] * 8, 4, 4, "ShardedGeometricPoisson(3, 4, "
                  "4, 8 shards, float32, auto)")
    # the plain path in float64 against the single-device solve
    prob = ShardedGeometricPoisson(3, 2, 4, devices=[device] * SHARDS,
                                   dtype=torch.float64, variant="sumfac")
    _, st = prob.solve()
    _, st1 = GeometricMultigridPoisson(3, 2, 4, torch.float64, "auto",
                                       device).solve()
    rel = abs(st.solution_l2_norm / st1.solution_l2_norm - 1.0)
    log(f"  ShardedGeometricPoisson(3, 2, 4, {SHARDS} shards, float64, "
        f"sumfac): {st.iterations} CG iterations (single device "
        f"{st1.iterations}), L2 {st.solution_l2_norm!r}, rel diff {rel:.2e}")
    if not (st.converged and st.iterations == st1.iterations
            and rel <= 1e-10):
        raise RuntimeError("sharded float64 plain path does not match the "
                           "single-device solve")
    count = torch.cuda.device_count()
    if count >= 2:
        k = 2 ** int(math.log2(min(4, count)))
        sharded_solve(card, [torch.device("cuda", i) for i in range(k)], 4,
                      6, f"ShardedGeometricPoisson(3, 4, 6) across {k} "
                      f"cards")
    else:
        log(f"  across cards: not run, this machine has {count} card")
    log("phase 16: ok")
    return times


# --------------------------------------------------------------------------
# phase 17: the 2D-pencil sharded solve, sx x sy pencils on one card
# --------------------------------------------------------------------------

PENCIL_MESH = (2, 2)  # the pencil main path's mesh on one card
# the pair modes of the pencil smoother (an odd step count's tail is a
# cheb2l pair)
PENCIL_PAIR_MODES = ("cheb2", "cheb2l", "cheb2f0", "cheb2f0l")
# the keys phase 17's pencil main path must launch: B.1's pencil apply (CG,
# residuals, the seeds of smooth) and B.2's pencil pairs at the production
# grade
PENCIL_KEYS = {"laplace": ("apply/pencil",),
               "cheb2": ("cheb2/pencil/mxu", "cheb2l/pencil/mxu",
                         "cheb2f0/pencil/mxu")}


def pencil_window(t: torch.Tensor, x0: int, nx: int, y0: int,
                  ny: int) -> torch.Tensor:
    """Planes x0 .. x0 + nx - 1 and rows y0 .. y0 + ny - 1 of a trimmed
    global field, zeros off the grid."""
    return halo(halo(t, x0, x0 + nx).transpose(0, 1), y0,
                y0 + ny).transpose(0, 1).contiguous()


def pencil_cases(p: int, r: int, mesh: tuple, s: int, device):
    """(kernel, :class:`Case`, single) for B.1's pencil ``apply`` and for
    each mode of B.2's pencil pair (exact and production grade, float32
    state) on pencil s of ``mesh`` at (p, r), float32: random global
    fields, the pencil's inputs cut from them; ``single`` the
    single-device pair's outputs at the pencil's points (the pencil's
    must be the same bit for bit), else None."""
    dtype = torch.float32
    sp = space(p, r)
    sx, sy = mesh
    devices = [device] * (sx * sy)
    rng = np.random.default_rng(s)
    cube = cuda_laplace.make_cuda_laplace(sp, dtype, device)
    u, rhs, x = global_fields(cube, rng, dtype, device)
    op = _build_pencil_kernel(sp, mesh, devices, dtype).local[s]
    Lx, Ly, _ = op.trimmed_shape
    lx, ly = s // sy * Lx, s % sy * Ly
    u_in = pencil_window(u, lx, Lx + 1, ly, Ly + 1)
    yield "laplace", Case("apply/pencil", lambda: op.run("apply", u_in),
                          lambda: op.twin("apply", u_in)), None
    if _build_pencil_cheb2(sp, mesh, devices, dtype) is None:
        return  # one-cell pencils: the smoother runs plain Chebyshev
    own = (slice(lx, lx + Lx), slice(ly, ly + Ly))
    for core in ("banded", "mxu"):
        gop = cube if core == "banded" else cuda_laplace.make_cuda_laplace(
            sp, dtype, device, core="mxu")
        kern = cuda_cheb2.make_cheb2_pencil(gop, lx, Lx, ly, Ly)
        whole = cuda_cheb2.make_cheb2(gop)
        d = pencil_window(u, lx - 2 * p, Lx + 4 * p, ly - 2 * p, Ly + 4 * p)
        rr = pencil_window(rhs, lx - p, Lx + 2 * p, ly - p, Ly + 2 * p)
        xs = x[own].contiguous()
        for mode in PENCIL_PAIR_MODES:
            f0 = mode.startswith("cheb2f0")
            has_x = mode in ("cheb2", "cheb2l")
            a = (d, None if f0 else rr, xs if has_x else None,
                 SCAL_PAIR_F0 if f0 else SCAL_PAIR)
            g = (u, None if f0 else rhs, x if has_x else None, a[3])
            key = cuda_laplace.launch_key(mode + "/pencil", gop.core, None)
            yield "cheb2", Case(
                key, lambda k=kern, a=a, m=mode: k.steps2(*a, m),
                lambda o=gop, a=a, m=mode: cuda_cheb2.cheb2_twin_pencil(
                    o, lx, Lx, ly, Ly, *a, m),
                mags=(lambda o=gop, g=g, m=mode: tuple(
                    t[own] for t in pair_magnitudes(o, *g, m)))
                if core == "mxu" else None), \
                (lambda w=whole, g=g, m=mode: tuple(
                    t[own] for t in w.steps2(*g, m)))


def phase_pencil(card: str, device, errs: dict, per_mode: dict) -> dict:
    """Phase 17: the 2D-pencil sharded solve as sx x sy pencils on one
    card."""
    sx, sy = PENCIL_MESH
    log(f"phase 17: 2D-pencil sharded solve, {sx} x {sy} pencils on one "
        f"card ({card})")
    same = collections.Counter()
    # every degree at r = 3, the odd ones on the upper corner pencil of
    # (2, 2), the even ones on an edge pencil of (4, 2)
    cases = [(p, 3, (2, 2), 3) if p % 2 else (p, 3, (4, 2), 2)
             for p in range(1, 8)]
    # the main path's fine pencils: a corner (2, 2), an edge (4, 2) and an
    # interior one (4, 4)
    cases += [(4, 6, (2, 2), 0), (4, 6, (4, 2), 2), (4, 6, (4, 4), 6)]
    for p, r, mesh, s in cases:
        same.update(sharded_compare(p, r, mesh, (s,), device, errs,
                                    cases=pencil_cases))
    for grade in ("exact", "mxu"):
        log(f"  B.2 pencil at the {grade} grade: {same[grade, 'bitwise']} of "
            f"{same[grade, 'outputs']} outputs equal to the single-device "
            f"pair's bit for bit")
        if same[grade, "bitwise"] != same[grade, "outputs"]:
            raise RuntimeError(f"B.2 pencil at the {grade} grade: not every "
                               f"output is the single-device pair's")
    times = time_sharded_modes(4, 6, PENCIL_MESH, device, 0, pencil=True)
    devices = [device] * (sx * sy)
    st, launches, _ = sharded_solve(card, devices, 4, 6,
                                    f"Sharded2DGeometricPoisson(3, 4, 6, "
                                    f"{PENCIL_MESH}, float32, auto)",
                                    timing=True, mesh=PENCIL_MESH)
    l2_rel = abs(st.solution_l2_norm / GOLDEN_L2_Q4_R6 - 1.0)
    log(f"  L2 {st.solution_l2_norm:.10f}, rel diff {l2_rel:.2e} from the "
        f"golden {GOLDEN_L2_Q4_R6}")
    if l2_rel > F32_L2_BOUND_3D:
        raise RuntimeError(f"pencil main path L2 off by {l2_rel:.2e}")
    for name, keys in PENCIL_KEYS.items():
        missing = [k for k in keys if not launches[name].get(k)]
        if missing:
            raise RuntimeError(f"pencil main path: {name} never launched "
                               f"{missing}")
        per_mode[name].update(launches[name])
    sharded_solve(card, [device] * 8, 4, 4, "Sharded2DGeometricPoisson(3, "
                  "4, 4, (4, 2), float32, auto)", mesh=(4, 2))
    # the plain path in float64 against the single-device solve
    _, st = Sharded2DGeometricPoisson(3, 2, 4, PENCIL_MESH,
                                      devices=devices).solve()
    _, st1 = GeometricMultigridPoisson(3, 2, 4, torch.float64, "auto",
                                       device).solve()
    rel = abs(st.solution_l2_norm / st1.solution_l2_norm - 1.0)
    log(f"  Sharded2DGeometricPoisson(3, 2, 4, {PENCIL_MESH}, float64, "
        f"kron): {st.iterations} CG iterations (single device "
        f"{st1.iterations}), L2 {st.solution_l2_norm!r}, rel diff {rel:.2e}")
    if not (st.converged and st.iterations == st1.iterations
            and rel <= 1e-12):
        raise RuntimeError("pencil float64 plain path does not match the "
                           "single-device solve")
    log("phase 17: ok")
    return times


# --------------------------------------------------------------------------
# phase 18: the slab-sharded elasticity solve, S shards on one card
# --------------------------------------------------------------------------


def elasticity_slab_cases(p: int, r: int, S: int, shards, dtype, device):
    """(shard, B.5's slab on that shard of S at (p, r), mu = 0.7, lam =
    1.3, its x-full input) for each of ``shards``: a random field, zero on
    the constrained planes."""
    from portable_multigrid_tpu_torch.parallel.elasticity import (
        sharded_cuda_elasticity,
    )

    slabs = sharded_cuda_elasticity(space(p, r), [device] * S, dtype,
                                    *MU_LAM).local
    for s in shards:
        _, L, N, _ = slabs[s].trimmed_shape
        u = np.random.default_rng(s).standard_normal((3, L + 1, N, N))
        gx = s * L + np.arange(L + 1)
        u[:, (gx == 0) | (gx >= N)] = 0.0
        u[:, :, 0], u[:, :, :, 0] = 0.0, 0.0
        yield s, slabs[s], torch.as_tensor(u, dtype=dtype, device=device)


def elasticity_slab_compare(p: int, r: int, S: int, shards, dtype, device,
                            errs: dict) -> None:
    """B.5's slab ``apply`` against its twin on the given shards, within
    BOUND of the twin's max magnitude; the max error into ``errs``."""
    name = str(dtype).split(".")[-1]
    for s, op, u in elasticity_slab_cases(p, r, S, shards, dtype, device):
        (got,), (want,) = op.run("apply", u), op.twin("apply", u)
        synchronize(device)
        if not torch.isfinite(got).all() or got.shape != want.shape:
            raise RuntimeError(f"elasticity apply/slab p={p} r={r} shard "
                               f"{s}/{S} {name}: non-finite or shape "
                               f"{tuple(got.shape)}")
        err, rel = rel_err(got, want)
        key = ("elasticity", "apply/slab", p, r, name)
        errs[key] = max(errs.get(key, 0.0), err)
        seen = f"max rel err {rel:.3e} (bound {BOUND[dtype]:.0e})"
        log(f"  elasticity apply/slab p={p} r={r} shard {s}/{S} {name:7s} "
            f"{seen}")
        if rel > BOUND[dtype]:
            raise RuntimeError(f"elasticity apply/slab p={p} r={r} shard "
                               f"{s}/{S} {name}: {seen}")


def time_elasticity_slab(p: int, r: int, S: int, device, s: int = 1) -> dict:
    """B.5's slab ``apply`` on shard s of S at (p, r), float32: kernel and
    twin ms (CUDA events, median of 10), the bound from this call's bytes
    (the x-full input read once, the output written once) and FMAs (45
    banded products of 2p+1 a grid point of the output)."""
    _, op, u = next(elasticity_slab_cases(p, r, S, (s,), torch.float32,
                                          device))
    run, twin = (lambda: op.run("apply", u)), (lambda: op.twin("apply", u))
    t_k, t_t = cuda_ms(run), cuda_ms(twin)
    _, L, N, _ = op.trimmed_shape
    b_ms, by = roofline(4 * 3 * (2 * L + 1) * N * N,
                        PRODUCTS["elasticity"] * (2 * p + 1) * L * N * N,
                        False)
    log(f"  elasticity apply/slab p={p} r={r} shard {s}/{S} (3 x {L + 1} x "
        f"{N} x {N} in): kernel {t_k:8.3f} ms   twin {t_t:8.3f} ms   bound "
        f"{b_ms:.4f} ms ({by}, {100 * b_ms / t_k:.1f}% of roofline)   "
        f"device {device_ms(run):.3f} ms back to back")
    return {("elasticity", "apply/slab"): dict(
        ms=t_k, plain_ms=t_t, library_ms=None, bound_ms=b_ms, bound_by=by)}


def count_level_applies(levels) -> collections.Counter:
    """Shadow each level operator's ``apply`` with one that counts its
    calls by level (removed by :func:`uncount_level_applies`)."""
    calls = collections.Counter()
    for k, lvl in enumerate(levels):
        def counted(u, orig=lvl.op.apply, k=k):
            calls[k] += 1
            return orig(u)

        lvl.op.apply = counted
    return calls


def uncount_level_applies(levels) -> None:
    for lvl in levels:
        del lvl.op.apply


def elasticity_launches() -> dict:
    """B.5's launches by key since the last reset."""
    return {k: n for k, n in cuda_elasticity.LAUNCHES.items() if n}


def sharded_elasticity_solve(card: str, devices, p: int, r: int, what: str,
                             timing: bool = False):
    """The sharded elasticity solve on the kernel path in float32 to rtol
    1e-5 against the single-device solve at the exact grade: converged, at
    most one CG iteration more, L2 within F32_L2_BOUND_ELASTICITY of the
    single device's, B.5's slab launched and no cube mode; returns (stats,
    launches of construction and solve, times).  With ``timing`` both
    eager V-cycles in turns, the busy shares and the launches per sharded
    V-cycle, which must include every level's."""
    from portable_multigrid_tpu_torch.parallel.elasticity import (
        ShardedElasticity,
        shard_vector,
    )

    device = devices[0]
    reset_counts()
    t0 = time.perf_counter()
    prob = ShardedElasticity(3, p, r, devices=devices, dtype=torch.float32,
                             variant="auto")
    synchronize(device)
    t_setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, st = prob.solve(rtol=1e-5, verbose=True)
    synchronize(device)
    t_solve = time.perf_counter() - t0
    launches = elasticity_launches()
    log(f"  {what}: setup {t_setup:.2f} s, solve {t_solve:.2f} s; B.5 "
        f"launches (construction and solve) {launches}")
    if not launches.get("apply/slab") or set(launches) != {"apply/slab"}:
        raise RuntimeError(f"{what}: B.5 launches {launches}, expected "
                           f"apply/slab alone")
    if (not np.isfinite(x).all()
            or x.shape != (3,) + prob.spaces[-1].grid_shape):
        raise RuntimeError(f"{what}: solution not finite or wrong shape")
    old = os.environ.get("PMG_ELASTICITY_MXU")
    os.environ["PMG_ELASTICITY_MXU"] = "0"  # the exact grade
    try:
        single = ElasticityMultigrid(3, p, r, dtype=torch.float32,
                                     variant="auto", device=device)
    finally:
        if old is None:
            del os.environ["PMG_ELASTICITY_MXU"]
        else:
            os.environ["PMG_ELASTICITY_MXU"] = old
    x1, st1 = single.solve(rtol=1e-5, graph=False)
    x1 = x1.cpu().numpy()
    rel = abs(st.solution_l2_norm / st1.solution_l2_norm - 1.0)
    diff = float(np.abs(x - x1).max() / np.abs(x1).max())
    log(f"  {what}: {st.iterations} CG iterations (single device, exact "
        f"grade: {st1.iterations}), L2 {st.solution_l2_norm:.10f} against "
        f"{st1.solution_l2_norm:.10f}, rel diff {rel:.2e}; x within "
        f"{diff:.3e} of max |x|")
    if not (st.converged and st.iterations <= st1.iterations + 1
            and rel <= F32_L2_BOUND_ELASTICITY):
        raise RuntimeError(f"{what}: converged={st.converged}, "
                           f"{st.iterations} CG iterations against "
                           f"{st1.iterations}, L2 off by {rel:.2e}")
    times = {}
    if timing:
        # one assembly of the load vector (seconds of host work at r = 6)
        rhs1 = single.rhs()
        rhs = shard_vector(rhs1.cpu().numpy(), 2 ** r, p, devices,
                           torch.float32)
        mg, v1 = prob.preconditioner(), single.preconditioner(graph=False)
        turns = time_turns({"sharded eager": mg, "single eager": v1},
                           {"sharded eager": rhs, "single eager": rhs1})
        for name, ts in turns.items():
            log(f"  V-cycle {name:13s} (float32, exact grade): {ts[0]:.3f} / "
                f"{ts[1]:.3f} ms = {st.n_dofs / (min(ts) * 1e-3):.4e} DoF/s "
                f"[{card}]")
        device_busy(mg, rhs, statistics.mean(turns["sharded eager"]),
                    "sharded eager")
        device_busy(v1, rhs1, statistics.mean(turns["single eager"]),
                    "single eager")
        calls = count_level_applies(prob.levels)
        reset_counts()
        mg.apply(rhs)
        synchronize(device)
        uncount_level_applies(prob.levels)
        per_vcycle = elasticity_launches()
        by_level = {f"r={sp.mesh.refinements}": calls[k]
                    for k, sp in enumerate(prob.spaces)}
        log(f"  launches per sharded V-cycle: {per_vcycle}; operator "
            f"applies by level {by_level}, {len(devices)} slab launches "
            f"each")
        if (any(calls[k] == 0 for k in range(len(prob.levels)))
                or per_vcycle != {"apply/slab": len(devices)
                                  * sum(calls.values())}):
            raise RuntimeError(f"{what}: apply/slab not launched on every "
                               f"level: {per_vcycle}, {by_level}")
        reset_counts()
        times = turns
    return st, launches, times


def phase_sharded_elasticity(card: str, device, errs: dict,
                             per_mode: dict) -> dict:
    """Phase 18: the slab-sharded elasticity solve as S shards on one
    card."""
    from portable_multigrid_tpu_torch.parallel.elasticity import (
        ShardedElasticity,
    )

    log(f"phase 18: slab-sharded elasticity solve, {SHARDS} shards on one "
        f"card ({card})")
    for dtype in (torch.float32, torch.float64):
        for p in range(1, 8):
            elasticity_slab_compare(p, 3, SHARDS, (0, 1, SHARDS - 1), dtype,
                                    device, errs)
        # the fine slab of the Q3 r=6 solve: 16 cells, 3 x 49 x 192^2 in
        elasticity_slab_compare(3, 6, SHARDS, (1,), dtype, device, errs)
    times = time_elasticity_slab(3, 6, SHARDS, device)
    _, launches, _ = sharded_elasticity_solve(
        card, [device] * SHARDS, 3, 6, f"ShardedElasticity(3, 3, 6, "
        f"{SHARDS} shards, float32, auto)", timing=True)
    per_mode["elasticity"].update(launches)
    # the plain path in float64 against the single-device solve
    x, st = ShardedElasticity(3, 2, 3, devices=[device] * SHARDS).solve()
    x1, st1 = ElasticityMultigrid(3, 2, 3, dtype=torch.float64,
                                  variant="kron", device=device).solve()
    x1 = x1.cpu().numpy()
    diff = float(np.abs(x - x1).max() / np.abs(x1).max())
    log(f"  ShardedElasticity(3, 2, 3, {SHARDS} shards, float64, sumfac): "
        f"{st.iterations} CG iterations (single device {st1.iterations}), "
        f"L2 {st.solution_l2_norm!r}, x within {diff:.2e} of max |x|")
    if not (st.converged and diff <= 1e-10):
        raise RuntimeError("sharded elasticity float64 plain path does not "
                           "match the single-device solve")
    count = torch.cuda.device_count()
    if count >= 2:
        k = 2 ** int(math.log2(min(4, count)))
        sharded_elasticity_solve(
            card, [torch.device("cuda", i) for i in range(k)], 3, 6,
            f"ShardedElasticity(3, 3, 6) across {k} cards")
    else:
        log(f"  across cards: not run, this machine has {count} card")
    log("phase 18: ok")
    return times


# ---------------------------------------------------------------------------
# phase 19: general geometry (driver 3 and the deformed and curved models);
# the JAX package runs no Pallas kernel on this path, so it launches no
# kernel of the port: every level is plain torch
# ---------------------------------------------------------------------------
# the curved annulus sector of tests/test_curved.py: r in [1, 2], theta in
# [0, pi/2], u = sin(pi (r - 1)) sin(2 theta), f = -Δu
ANNULUS = (1.0, 2.0, np.pi / 2)
# card against the port on the CPU (float64, max error over max |want|);
# a model's solve against np.linalg.solve of its dense oracle (of max |x|)
GENERAL_BOUND = 1e-12
GENERAL_X_BOUND = 1e-9
# the JAX package's bars (tests/test_unstructured_mg.py:116,
# tests/test_indexed.py:87, tests/test_curved.py:158-161): CG counts of the
# unstructured, deformed and curved solves, and the curved L2 rate above
# p + CURVED_RATE_MARGIN
MAX_CG_GENERAL = {"unstructured": 8, "deformed": 12, "curved": 8}
CURVED_RATE_MARGIN = 0.6
# CG counts of the JAX package's CurvedMultigrid(2, 3, r, annulus) by r,
# float64, rtol 1e-12, as its CPU run prints them from the repo root:
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu')
#   jax.config.update('jax_enable_x64', True); import chip_smoke as c
#   from portable_multigrid_tpu.models.general_geometry import CurvedMultigrid
#   print([CurvedMultigrid(2, 3, r, c.annulus).solve(c.annulus_f)[1]
#          .iterations for r in (2, 3, 4, 6, 7)])"
# The count rises from 6 at r=3 to 8 at r=6 and r=7, so r=8 is held to
# within one of r=7's (and to MAX_CG_GENERAL), the card's r=2 and r=3
# solves to these counts exactly.
CURVED_JAX_CG = {2: 5, 3: 6, 4: 7, 6: 8, 7: 8}
# driver 3 at full width: 64^3 cells of Q2 from a perturbed 4^3 mesh
DRIVER3_ARGS = ["--dim", "3", "--degree", "2", "--base-cells", "4",
                "--refinements", "4"]
DRIVER3_DOFS = 2146689


def annulus(s, t):
    r = ANNULUS[0] + s * (ANNULUS[1] - ANNULUS[0])
    th = t * ANNULUS[2]
    return r * np.cos(th), r * np.sin(th)


def annulus_exact(x, y):
    r0, r1, th_max = ANNULUS
    r, th = np.hypot(x, y), np.arctan2(y, x)
    return np.sin(np.pi * (r - r0) / (r1 - r0)) * np.sin(np.pi * th / th_max)


def annulus_f(x, y):
    """-Δ annulus_exact in polar coordinates."""
    r0, r1, th_max = ANNULUS
    r, th = np.hypot(x, y), np.arctan2(y, x)
    dr = r1 - r0
    rr = np.sin(np.pi * (r - r0) / dr)
    drr = (np.pi / dr) * np.cos(np.pi * (r - r0) / dr)
    t = np.sin(np.pi * th / th_max)
    return ((np.pi / dr) ** 2 * rr - drr / r
            + (np.pi / th_max) ** 2 * rr / r ** 2) * t


def general_pieces(device) -> dict:
    """Each operator kind of the general-geometry path at a small size, with
    the transfer from the level below, float64 on ``device``: name ->
    (operator, transfer, coarse vector length)."""
    f64 = torch.float64

    def structured(dim, p, r, geometry):
        fine, coarse = space(p, r, dim), space(p, r - 1, dim)
        tr = FlatTransfer(coarse.grid_shape, fine.grid_shape,
                          make_h_transfer(coarse, fine, f64, device))
        return (make_indexed_laplace(fine, geometry, f64, device), tr,
                coarse.n_dofs)

    gm0 = perturbed_cube_mesh(3, 2, 0.15, 7)
    gm1 = refine_general_mesh(gm0)
    packs = [enumerate_dofs(gm0, 2), enumerate_dofs(gm1, 2)]
    return {
        "Cartesian 3D Q2 r=2": structured(3, 2, 2, None),
        "perturbed 2D Q3 4^2": structured(2, 3, 2,
                                          perturbed_cube_mesh(2, 4, 0.2)),
        "perturbed 3D Q2 4^3": structured(3, 2, 2,
                                          perturbed_cube_mesh(3, 4, 0.2)),
        "curved annulus Q3 4^2": structured(
            2, 3, 2, curved_structured_geometry(2, 4, annulus, 3)),
        "unstructured 3D Q2 16 cells": (
            make_unstructured_laplace(gm1, 2, f64, packs[1], device),
            make_unstructured_h_transfer(gm0, 2, packs[0], packs[1], f64,
                                         device),
            packs[0][0]),
    }


def general_compare(device) -> None:
    """Apply, prolongate and restrict of each operator kind on the card
    within GENERAL_BOUND of the port on the CPU, and bit for bit equal
    over two calls on the same input."""
    cpu = general_pieces(torch.device("cpu"))
    card = general_pieces(device)
    rng = np.random.default_rng(19)
    for name, (op, tr, n_c) in cpu.items():
        cop, ctr, _ = card[name]
        fine = rng.standard_normal(op.n_dofs)
        coarse = rng.standard_normal(n_c)
        for what, fn, cfn, v in (("apply", op.apply, cop.apply, fine),
                                 ("prolongate", tr.prolongate,
                                  ctr.prolongate, coarse),
                                 ("restrict", tr.restrict, ctr.restrict,
                                  fine)):
            want = fn(torch.as_tensor(v))
            u = torch.as_tensor(v, device=device)
            got, again = cfn(u), cfn(u)
            rel = rel_err(got.cpu(), want)[1]
            same = bool(torch.equal(got, again))
            log(f"  {name} {what}: card vs CPU {rel:.2e} of max; two calls "
                f"bit for bit equal: {same}")
            if not (rel <= GENERAL_BOUND and same):
                raise RuntimeError(f"{name} {what}: card vs CPU {rel:.2e}, "
                                   f"repeatable {same}")


def general_solve_both(prob, what: str, *args):
    """The model's solve eagerly and through its graphed V-cycle: the same
    CG count, x within GRAPH_BOUND; then the graphed solve again, timed.
    Returns the solution (graphed), its stats and the timed solve's ms."""
    sync = prob.device
    t0 = time.perf_counter()
    xe, se = prob.solve(*args, graph=False)
    synchronize(sync)
    t_eager = time.perf_counter() - t0
    t0 = time.perf_counter()
    x, st = prob.solve(*args)
    synchronize(sync)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    x2, _ = prob.solve(*args)
    synchronize(sync)
    t_solve = time.perf_counter() - t0
    err = rel_err(x, xe)[1]
    capture = ""
    if prob.device.type == "cuda":
        mg = prob.preconditioner()
        warm, cap = next(iter(mg.capture_seconds.values()))
        capture = f" (warm-up {warm:.3f} s, capture {cap:.3f} s)"
        if not isinstance(mg, GraphedVCycle):
            raise RuntimeError(f"{what}: no graphed V-cycle")
    log(f"  {what}: {st.n_dofs} DoFs by level {st.dofs_per_level}; eager "
        f"{se.iterations} CG iterations in {t_eager:.3f} s, graphed "
        f"{st.iterations} in {t_first:.3f} s{capture}, again "
        f"{t_solve * 1e3:.1f} ms; graphed vs eager {err:.2e} of max |x|, "
        f"residual {st.residual_norm:.3e}")
    if (st.iterations != se.iterations or not err <= GRAPH_BOUND[x.dtype]
            or not torch.equal(x, x2) or not st.converged):
        raise RuntimeError(f"{what}: graphed {st.iterations} vs eager "
                           f"{se.iterations} CG iterations, x off by "
                           f"{err:.2e}, converged {st.converged}")
    if not torch.isfinite(x).all() or x.device != prob.device:
        raise RuntimeError(f"{what}: solution not finite or off the device")
    return x, st, t_solve * 1e3


def general_dense_solves(device) -> None:
    """UnstructuredMultigrid (3D Q2, base 2, 1 refinement) and
    GeneralGeometryMultigrid (2D Q2 r=3 on the 8 x 8 perturbed mesh)
    against np.linalg.solve of their dense oracles: x within
    GENERAL_X_BOUND of max |x|, graphed equal to eager."""
    prob = UnstructuredMultigrid(perturbed_cube_mesh(3, 2, 0.15, 7), 2, 1,
                                 device=device)
    x, st, _ = general_solve_both(prob, "UnstructuredMultigrid 3D Q2 1 ref.")
    gm = prob.meshes[-1]
    n_dofs, l2g, mask = prob.dof_packs[-1]
    rhs = assemble_rhs_indexed(gm, l2g, 2, n_dofs, mask,
                               lambda *c: np.ones_like(c[0]))
    dense_check("UnstructuredMultigrid", x, st,
                np.linalg.solve(dense_unstructured_operator(gm, 2), rhs),
                MAX_CG_GENERAL["unstructured"])
    gm = perturbed_cube_mesh(2, 8, 0.15)
    prob = GeneralGeometryMultigrid(gm, 2, 3, device=device)
    x, st, _ = general_solve_both(prob, "GeneralGeometryMultigrid 2D Q2 r=3")
    sp = prob.spaces[-1]
    b = (np.random.default_rng(0).standard_normal(sp.n_dofs)
         * sp.free_mask().reshape(-1))
    dense_check("GeneralGeometryMultigrid", x, st,
                np.linalg.solve(dense_indexed_operator(sp, gm), b),
                MAX_CG_GENERAL["deformed"])


def dense_check(what: str, x, st, want: np.ndarray, max_cg: int) -> None:
    err = float(np.abs(x.cpu().numpy() - want).max() / np.abs(want).max())
    log(f"  {what}: {st.iterations} CG iterations, x within {err:.2e} of "
        f"max |x| of the dense solve")
    if not (st.converged and st.iterations <= max_cg
            and err <= GENERAL_X_BOUND):
        raise RuntimeError(f"{what}: {st.iterations} CG iterations, x off "
                           f"the dense solve by {err:.2e}")


def log_setup(what: str, prob, seconds: float) -> None:
    log(f"  {what}: host setup {seconds:.2f} s, by step: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in prob.setup_seconds.items()))


def general_timing(card: str, prob, what: str) -> None:
    """The fine apply's device ms beside its bound, the eager and the
    graphed V-cycle in turns (median of 10), their busy shares and the
    device launches per eager V-cycle."""
    op = prob.fine_operator
    u = op.mask.clone()
    ms = device_ms(lambda: op.apply(u))
    # each input read once, the output written once: the metric, l2g and
    # the scatter table, u, the mask and the result
    nbytes = sum(t.numel() * t.element_size()
                 for t in (op.metric, op.l2g, op.scatter, u, op.mask, u))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  {what}: fine apply {ms:.3f} ms device time, bound {bound:.3f} ms "
        f"(bytes: {nbytes / 1e6:.1f} MB), {100 * bound / ms:.1f}% of "
        f"roofline [{card}]")
    _, rows = graph_report(card, prob, u, op.n_dofs)
    log(f"  {what}: {sum(r[1] for r in rows)} device launches per eager "
        f"V-cycle ({len(rows)} kernels by name)")


def start_driver3(tmp: str) -> subprocess.Popen:
    """Driver 3 at full width through its command line, in a child process
    whose output goes to a file in ``tmp``."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = open(os.path.join(tmp, "driver3.log"), "w")
    try:
        return subprocess.Popen(
            [sys.executable, "-m",
             "portable_multigrid_tpu_torch.programs.unstructured_multigrid",
             *DRIVER3_ARGS, "--vtu", os.path.join(tmp, "driver3.vtu")],
            cwd=root, stdout=out, stderr=subprocess.STDOUT, text=True)
    finally:
        out.close()


def check_driver3(proc: subprocess.Popen, tmp: str) -> None:
    """Driver 3's run: exit 0, the native enumerator, DRIVER3_DOFS on 5
    levels, at most MAX_CG_GENERAL["unstructured"] CG iterations, the .vtu
    written with every fine vertex."""
    rc = proc.wait(timeout=900)
    with open(os.path.join(tmp, "driver3.log")) as fh:
        out = fh.read()
    for line in out.splitlines():
        log(f"  driver 3 | {line}")
    if rc != 0:
        raise RuntimeError(f"driver 3 exited with {rc}")
    dofs = re.search(r" (\d+) unstructured DoFs \(by level: (.*)\)", out)
    its = re.search(r"Solver converged in (\d+) iterations", out)
    if (not dofs or int(dofs.group(1)) != DRIVER3_DOFS
            or len(dofs.group(2).split(",")) != 5 or not its
            or int(its.group(1)) > MAX_CG_GENERAL["unstructured"]
            or "DoF enumerator: native" not in out):
        raise RuntimeError("driver 3 did not solve as its bars require")
    with open(os.path.join(tmp, "driver3.vtu")) as fh:
        head = fh.read(4096)
    points = re.search(r'NumberOfPoints="(\d+)" NumberOfCells="(\d+)"', head)
    if not points or int(points.group(2)) != 64 ** 3:
        raise RuntimeError("driver 3's .vtu lacks the fine mesh")
    log(f"  driver 3 wrote {os.path.getsize(os.path.join(tmp, 'driver3.vtu'))}"
        f" bytes of .vtu: {points.group(1)} vertices, {points.group(2)} cells")


def curved_solve(r: int, device):
    prob = CurvedMultigrid(2, 3, r, annulus, device=device)
    x, st = prob.solve(annulus_f)
    return prob, x, st, prob.l2_error(x, annulus_exact)


def phase_general(card: str, device) -> None:
    """Phase 19: general geometry, small against the CPU and dense oracles,
    then driver 3 and the deformed and curved models at full width."""
    log(f"phase 19: general geometry on {card}")
    if not native_available():
        raise RuntimeError("the native DoF enumerator did not build")
    log(f"  DoF enumerator: native ({native.LIB_PATH})")
    with tempfile.TemporaryDirectory() as tmp:
        proc = start_driver3(tmp)
        try:
            general_compare(device)
            general_dense_solves(device)
            # (a) in this process too, for its V-cycle, while the driver runs
            t0 = time.perf_counter()
            prob = UnstructuredMultigrid(perturbed_cube_mesh(3, 4, 0.15), 2,
                                         4, device=device)
            log_setup("(a) UnstructuredMultigrid 3D Q2 4^3 + 4 refinements",
                      prob, time.perf_counter() - t0)
            check_driver3(proc, tmp)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    general_timing(card, prob, "(a) driver 3")
    del prob
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    prob = GeneralGeometryMultigrid(perturbed_cube_mesh(3, 32, 0.15), 4, 5,
                                    device=device)
    log_setup("(b) GeneralGeometryMultigrid 3D Q4 32^3", prob,
              time.perf_counter() - t0)
    _, st, _ = general_solve_both(prob, "(b) deformed Q4 r=5")
    if st.iterations > MAX_CG_GENERAL["deformed"]:
        raise RuntimeError(f"(b): {st.iterations} CG iterations")
    general_timing(card, prob, "(b) deformed Q4 r=5")
    del prob
    torch.cuda.empty_cache()

    errs = []
    for r in (2, 3):
        _, _, st, err = curved_solve(r, device)
        errs.append(err)
        log(f"  (c) CurvedMultigrid 2D Q3 r={r}: {st.iterations} CG "
            f"iterations (JAX package {CURVED_JAX_CG[r]}), L2 error "
            f"{err:.6e}")
        if st.iterations != CURVED_JAX_CG[r]:
            raise RuntimeError(f"curved r={r}: {st.iterations} CG "
                               f"iterations")
    rate = math.log2(errs[0] / errs[1])
    log(f"  (c) L2 rate r=2 -> 3: {rate:.3f} (bar {3 + CURVED_RATE_MARGIN})")
    if rate <= 3 + CURVED_RATE_MARGIN:
        raise RuntimeError(f"curved: L2 rate {rate:.3f}")
    t0 = time.perf_counter()
    prob = CurvedMultigrid(2, 3, 8, annulus, device=device)
    log_setup("(c) CurvedMultigrid 2D Q3 r=8", prob, time.perf_counter() - t0)
    x, st, _ = general_solve_both(prob, "(c) curved Q3 r=8", annulus_f)
    log(f"  (c) L2 error at r=8: {prob.l2_error(x, annulus_exact):.6e}")
    if (st.iterations > MAX_CG_GENERAL["curved"]
            or abs(st.iterations - CURVED_JAX_CG[7]) > 1):
        raise RuntimeError(f"(c): {st.iterations} CG iterations at r=8 "
                           f"against the JAX package's {CURVED_JAX_CG[7]} "
                           f"at r=7")
    general_timing(card, prob, "(c) curved Q3 r=8")
    del prob
    torch.cuda.empty_cache()
    log("phase 19: ok")


# --------------------------------------------------------------------------
# phase 20: the untrimmed path (the JAX package's bench.py with
# PMG_BENCH_TRIMMED=0), B.1's untrimmed residual on every smoothing level
# --------------------------------------------------------------------------
UNTRIMMED_MAX_CG = 4


def phase_untrimmed(card: str, device, prob, times) -> int:
    """Phase 20: the V-cycle of ``build_untrimmed_vcycle`` over the main
    path's spaces (Q4 r=6, float32) under CG, counted from zero; returns
    the launches of B.1's ``residual`` in that solve."""
    log(f"phase 20: untrimmed path build_untrimmed_vcycle(Q4 r=6, float32) "
        f"on {card}")
    t0 = time.perf_counter()
    mg = build_untrimmed_vcycle(prob.spaces, torch.float32, device)
    synchronize(device)
    t_setup = time.perf_counter() - t0
    fine_op = prob.fine_operator
    rhs = prob.rhs()
    n_dofs = prob.spaces[-1].n_dofs
    reset_counts()
    t0 = time.perf_counter()
    res = cg(fine_op.apply, rhs, mg.apply, rtol=1e-5)
    synchronize(device)
    t_solve = time.perf_counter() - t0
    counts = {name: {m: n for m, n in KERNELS[name]["counts"].items() if n}
              for name in ("laplace", "cheb2", "transfer")}
    reset_counts()
    graphed = GraphedVCycle(mg)
    res_g = cg(fine_op.apply, rhs, graphed.apply, rtol=1e-5)
    synchronize(device)
    reset_counts()
    singles = grade_vcycle(prob, pairs=False)
    its_single = cg(fine_op.apply, rhs, singles.apply, rtol=1e-5).iterations
    x = res_g.x.cpu().numpy().astype(np.float64)
    l2 = prob.solution_l2_norm(x)
    l2_rel = abs(l2 / GOLDEN_L2_Q4_R6 - 1.0)
    diff = rel_err(res_g.x, res.x)[1]
    log(f"  setup {t_setup:.2f} s, eager solve {t_solve:.2f} s: CG "
        f"{res.iterations} iterations eagerly, {res_g.iterations} graphed "
        f"(graphed vs eager max rel diff {diff:.2e}); the trimmed "
        f"single-step path {its_single}; L2 {l2:.10f} (rel diff {l2_rel:.2e} "
        f"from the golden {GOLDEN_L2_Q4_R6})")
    log(f"  launches of the eager solve by mode: {counts}")
    lap = counts["laplace"]
    stray = [k for k in lap if k.startswith(("residual1t", "residual3t"))]
    if not (res.converged and res_g.converged
            and res.iterations <= UNTRIMMED_MAX_CG
            and res.iterations == res_g.iterations == its_single
            and diff <= GRAPH_BOUND[torch.float32]
            and l2_rel <= F32_L2_BOUND_3D):
        raise RuntimeError(f"untrimmed path: {res.iterations} / "
                           f"{res_g.iterations} CG iterations against "
                           f"{its_single}, L2 off by {l2_rel:.2e}")
    if not (lap.get("residual", 0) and any(k.endswith("/mxu/bf16")
                                           for k in lap)) or stray \
            or counts["cheb2"] or counts["transfer"]:
        raise RuntimeError(f"untrimmed path launched {counts}: B.1's "
                           f"residual and mxu steps, and no trimmed "
                           f"residual, pair or B.3 transfer, expected")
    if not torch.isfinite(res.x).all() or tuple(res.x.shape) != fine_op.shape:
        raise RuntimeError("untrimmed path: solution not finite or wrong "
                           "shape")
    launches = lap["residual"]
    vcycles = {"untrimmed eager": mg, "untrimmed graphed": graphed,
               "singles eager": singles,
               "singles graphed": GraphedVCycle(singles)}
    wall, _ = graph_report(card, None, rhs, n_dofs, vcycles)
    slope = profiling.measure_op(lambda _: graphed.apply(rhs), rhs,
                                 repeats=3)
    log(f"  measure_op (utils.profiling, wall-clock slope over 2 and 8 "
        f"graphed V-cycles, best of 3): {slope * 1e3:.3f} ms against the "
        f"CUDA-event mean {wall['untrimmed graphed']:.3f} ms [{card}]")
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            mg.apply(rhs)
            synchronize(device)
        files = [os.path.join(tmp, f) for f in os.listdir(tmp)]
        sizes = [os.path.getsize(f) for f in files]
        log(f"  utils.profiling.trace of one eager V-cycle: {len(files)} "
            f"file(s), {sizes} bytes")
        if len(files) != 1 or not sizes[0] > 0:
            raise RuntimeError("utils.profiling.trace wrote no trace")
    t = times[("laplace", "residual")]
    log(f"  B.1 residual at 257^3 in, 256^3 out: kernel {t['ms']:.3f} ms, "
        f"twin {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms "
        f"({t['bound_by']}, {100 * t['bound_ms'] / t['ms']:.1f}% of "
        f"roofline); {launches} launches in the solve [{card}]")
    fn, args = graft_entry.entry(device)
    out = fn(*args)
    synchronize(device)
    if not torch.isfinite(out).all() or tuple(out.shape) != (129,) * 3:
        raise RuntimeError("graft_entry.entry(): V-cycle not finite")
    log(f"  graft_entry.entry(): one V-cycle at Q4 r=5 (2,146,689 DoFs) "
        f"{cuda_ms(lambda: fn(*args)):.3f} ms eager [{card}]")
    reset_counts()
    del mg, graphed, singles, vcycles
    log("phase 20: ok")
    return launches


# --------------------------------------------------------------------------
# phase 21: any shard count (parallel/extended.py) and the dry runs, on one
# card
# --------------------------------------------------------------------------
EXT_X_BOUND = 1e-9
# The JAX package's extended solve bottoms out at S cells, not one, so its
# CG count exceeds the single device's: at (S, p, r) = (6, 4, 4) it takes
# 7 iterations against 4, as its CPU run prints from the repo root
# (L2 0.024987133131880033, equal to the port's to every digit):
#   python -c "import jax; jax.config.update('jax_platforms', 'cpu')
#   jax.config.update('jax_num_cpu_devices', 8)
#   jax.config.update('jax_enable_x64', True)
#   from portable_multigrid_tpu.parallel.extended import ExtendedShardedPoisson as E
#   s = E(3, 4, 4, devices=jax.devices()[:6]).solve(rtol=1e-10)[1]
#   print(s.iterations, repr(s.solution_l2_norm))"
# Elsewhere the sharded count is held within 2 of the single device's, the
# JAX package's bar (tests/test_sharding.py:364-392).
EXT_JAX_CG = {(6, 4, 4): 7}


def extended_solve(card: str, prob, p: int, r: int, what: str) -> None:
    """A float64 sharded solve to rtol 1e-10 against the single-device
    ``kron`` solve: converged within 2 CG iterations of it (or in the JAX
    package's count where EXT_JAX_CG pins it), the live x within
    EXT_X_BOUND of max |x|; both eager V-cycles in turns, with the single
    device's graphed one (3 runs each), and their busy shares (one
    profiled V-cycle each: the profiler's post-processing of a sharded
    V-cycle's ~10^4 events takes seconds of host time)."""
    device = prob.devices[0]
    t_start = t0 = time.perf_counter()
    x, st = prob.solve(rtol=1e-10, verbose=True)
    synchronize(device)
    t_solve = time.perf_counter() - t0
    t0 = time.perf_counter()
    single = GeometricMultigridPoisson(3, p, r, torch.float64, "kron",
                                       device)
    x1, st1 = single.solve(rtol=1e-10)
    synchronize(device)
    t_single = time.perf_counter() - t0
    x1 = x1.cpu().numpy()
    diff = float(np.abs(x - x1).max() / np.abs(x1).max())
    log(f"  {what}: solve {t_solve:.2f} s (the single device's setup and "
        f"solve {t_single:.2f} s), {st.iterations} CG iterations "
        f"(single-device kron {st1.iterations}), L2 "
        f"{st.solution_l2_norm:.12f} (single {st1.solution_l2_norm:.12f}), "
        f"x within {diff:.3e} of max |x|")
    pinned = EXT_JAX_CG.get((prob.n_shards, p, r))
    if not (st.converged and diff <= EXT_X_BOUND
            and (st.iterations == pinned if pinned else
                 st.iterations <= st1.iterations + 2)):
        raise RuntimeError(f"{what}: converged={st.converged}, "
                           f"{st.iterations} CG iterations against "
                           f"{st1.iterations}, x off by {diff:.3e}")
    rhs, rhs1 = prob.rhs(), single.rhs()
    mg, v1 = prob.preconditioner(), single.preconditioner(graph=False)
    vcycles = {"sharded eager": mg, "single eager": v1,
               "single graphed": single.preconditioner()}
    srcs = {"sharded eager": rhs, "single eager": rhs1,
            "single graphed": rhs1}
    turns = time_turns(vcycles, srcs, reps=3, warmup=1)
    for name, ts in turns.items():
        log(f"  V-cycle {name:15s}: {ts[0]:.3f} / {ts[1]:.3f} ms [{card}]")
    device_busy(mg, rhs, statistics.mean(turns["sharded eager"]),
                f"{what}, sharded eager", reps=1)
    device_busy(v1, rhs1, statistics.mean(turns["single eager"]),
                "single eager", reps=1)
    log(f"  {what}: {time.perf_counter() - t_start:.1f} s in all")


def dryrun_against_single(st, p: int, r: int, device, what: str) -> None:
    """A float64 solve of the dry run against the single-device ``kron``
    solve at its size: within 2 CG iterations of it (the JAX package's
    bar, tests/test_sharding.py:364-392), L2 within 1e-9 relative.  The
    dry runs' problems have 729 to 35,937 DoFs, so their V-cycles are not
    timed."""
    _, st1 = GeometricMultigridPoisson(3, p, r, torch.float64, "kron",
                                       device).solve(rtol=1e-10)
    dl2 = abs(st.solution_l2_norm - st1.solution_l2_norm) / abs(
        st1.solution_l2_norm)
    log(f"  {what}: {st.iterations} CG iterations (single-device kron Q{p} "
        f"r={r} {st1.iterations}), L2 {st.solution_l2_norm:.12f} (single "
        f"{st1.solution_l2_norm:.12f}, {dl2:.3e} relative)")
    if not (st.converged and st.iterations <= st1.iterations + 2
            and dl2 <= 1e-9):
        raise RuntimeError(f"{what}: {st.iterations} CG iterations against "
                           f"{st1.iterations}, L2 off by {dl2:.3e}")


def phase_extended(card: str, device) -> None:
    """Phase 21: ``ExtendedShardedPoisson`` on one card, float64: 3 shards
    at Q4 r=6 (96 x 64 x 64 extended cells, 25.4M points a vector) and 6
    at Q4 r=4; then ``graft_entry.dryrun_multichip(3)`` and ``(8)``, their
    float64 solves' CG counts and L2 against the single device."""
    log(f"phase 21: any shard count, ExtendedShardedPoisson on one card "
        f"({card})")
    for S, p, r in ((3, 4, 6), (6, 4, 4)):
        t0 = time.perf_counter()
        prob = ExtendedShardedPoisson(3, p, r, devices=[device] * S,
                                      dtype=torch.float64)
        synchronize(device)
        log(f"  ExtendedShardedPoisson(3, {p}, {r}), {S} shards: extended "
            f"axis {prob.n0s[-1]} cells, setup "
            f"{time.perf_counter() - t0:.2f} s")
        extended_solve(card, prob, p, r, f"extended Q{p} r={r} S={S}")
        del prob
        torch.cuda.empty_cache()
    for n in (3, 8):
        t0 = time.perf_counter()
        runs = graft_entry.dryrun_multichip(n, device)
        synchronize(device)
        log(f"  dryrun_multichip({n}) in {time.perf_counter() - t0:.2f} s")
        for key in ("1d", "2d"):
            if key in runs:
                dryrun_against_single(runs[key], *runs[f"{key}_size"],
                                      device, f"dryrun_multichip({n}) {key}")
    log("phase 21: ok")


def b5_hashes(device, path: str) -> None:
    """The SHA-256 of every output of every cube B.5 mode at phase 8's
    shapes on phase 8's seeded inputs, by (dtype, p, r, mode, output), to
    ``path`` (JSON)."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        for p, r in [(p, r) for r in (2, 3) for p in range(1, 8)] + [
                (3, r) for r in (1, 4, 5, 6)]:
            for name, c in level_cases("elasticity", p, r, dtype, device):
                if name != "elasticity":
                    continue
                for k, t in enumerate(c.run()):
                    out[f"{dtype} p={p} r={r} {c.mode} {k}"] = hashlib.sha256(
                        t.cpu().numpy().tobytes()).hexdigest()
            torch.cuda.empty_cache()
    with open(path, "w") as fh:
        json.dump(out, fh, indent=0, sort_keys=True)
    log(f"{len(out)} B.5 outputs hashed -> {path}")


def compare_hashes(a: str, b: str) -> int:
    """Whether the outputs of two :func:`b5_hashes` files are equal bit for
    bit: logs the count, returns 0 when all are."""
    with open(a) as fa, open(b) as fb:
        ha, hb = json.load(fa), json.load(fb)
    same = sum(ha[k] == hb.get(k) for k in ha)
    log(f"B.5 outputs bit for bit equal: {same} of {len(ha)} ({a} vs {b}; "
        f"{len(hb)} in the second)")
    return 0 if same == len(ha) == len(hb) else 1


def main(argv: list[str]) -> int:
    if argv[:1] == ["--compare-hashes"] and len(argv) == 3:
        return compare_hashes(*argv[1:])
    if argv not in ([], ["--main-path"], ["--general-geometry"]) and not (
            argv[:1] == ["--b5-hashes"] and len(argv) == 2):
        raise SystemExit(f"unknown arguments {argv}; see the module docstring")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card only")
    device = torch.device("cuda", 0)
    exact_matmuls()
    t_start = time.perf_counter()
    seconds = {}

    def timed(phase: int, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[phase] = time.perf_counter() - t0
        return out

    card = timed(1, phase_build)
    if argv[:1] == ["--b5-hashes"]:
        b5_hashes(device, argv[1])
        return 0
    if argv == ["--general-geometry"]:
        timed(19, phase_general, card, device)
        log("seconds by phase: " + ", ".join(f"{k} {v:.1f}"
                                             for k, v in seconds.items()))
        return 0
    if argv:
        prob, st, per_mode = timed(4, phase_main, device, 6, GOLDEN_L2_Q4_R6,
                                   4)
        timed(5, phase_timing, card, prob, st, device, per_mode)
        return 0
    dtypes = (torch.float32, torch.float64)
    shapes = [("3d", p, 2, dt) for dt in dtypes for p in range(1, 8)]
    # every level shape of the main path's kernel levels, 4^3 to 256^3,
    # and of config 3's p -> h ladder (p = 1 on 2^3..65^3 points, p = 2 on
    # 129^3; p = 4 on 257^3 is the main path's)
    shapes += [("3d", 4, r, dt) for dt in dtypes for r in (0, 1, 3, 4, 5, 6)]
    shapes += [("3d", 1, r, dt) for dt in dtypes for r in (0, 1, 3, 4, 5, 6)]
    shapes += [("3d", 2, 6, dt) for dt in dtypes]
    shapes += [("2d", p, r, dt) for dt in dtypes for r in (2, 3)
               for p in range(1, 8)]
    # every level shape of the 2D Q7 r=9 ladder, (512 p)^2, p = 1..7
    shapes += [("2d", p, 9, dt) for dt in dtypes for p in range(1, 8)]
    errs = timed(2, phase_compare, device, shapes)
    with open("tests/golden_convergence.json") as fh:
        timed(3, phase_golden, device, json.load(fh))
    prob, st, per_mode = timed(4, phase_main, device, 6, GOLDEN_L2_Q4_R6, 4)
    times = timed(5, phase_timing, card, prob, st, device, per_mode)
    residual_launches = timed(20, phase_untrimmed, card, device, prob, times)
    del prob
    torch.cuda.empty_cache()
    prob2, st2, per_mode2 = timed(6, phase_second, device, 9)
    times.update(timed(7, phase_second_timing, card, prob2, st2, device))
    per_mode.update(per_mode2)
    del prob2
    torch.cuda.empty_cache()
    shapes = [("elasticity", p, r, dt) for dt in dtypes for r in (2, 3)
              for p in range(1, 8)]
    # every other level shape of the Q3 r=6 solve, the fine one included
    shapes += [("elasticity", 3, r, dt) for dt in dtypes for r in (1, 4, 5, 6)]
    errs.update(timed(8, phase_compare, device, shapes, 8))
    timed(9, phase_elasticity_replay, device)
    prob3, st3, per_mode3 = timed(10, phase_elasticity, device, 6)
    times.update(timed(11, phase_elasticity_timing, card, prob3, st3, device))
    # B.3's launches are reported from the main path, where it was ported
    per_mode["elasticity"] = per_mode3["elasticity"]
    del prob3
    torch.cuda.empty_cache()
    timed(12, phase_mixed, card, device, 6)
    torch.cuda.empty_cache()
    timed(13, phase_mixed_precision, card, device, 6)
    torch.cuda.empty_cache()
    timed(14, phase_varcoef, card, device, 6)
    torch.cuda.empty_cache()
    timed(15, phase_variants, card, device, 6, 5)
    torch.cuda.empty_cache()
    times.update(timed(16, phase_sharded, card, device, errs, per_mode))
    torch.cuda.empty_cache()
    times.update(timed(17, phase_pencil, card, device, errs, per_mode))
    torch.cuda.empty_cache()
    times.update(timed(18, phase_sharded_elasticity, card, device, errs,
                       per_mode))
    torch.cuda.empty_cache()
    timed(19, phase_general, card, device)
    torch.cuda.empty_cache()
    timed(21, phase_extended, card, device)
    torch.cuda.empty_cache()
    log("seconds by phase: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in seconds.items()))
    log(f"all phases passed in {time.perf_counter() - t_start:.0f} s")
    log(card)  # the card's name and power limit, as nvidia-smi gives them

    # one entry per kernel and grade that its path launched: "laplace"
    # (exact float32), "laplace/bf16" (bf16 state), "cheb2/mxu/bf16" (the
    # production grade), "elasticity/mxu", "cheb2lr/mxu/bf16", ..., each
    # with its busiest mode
    kernels = []
    for name, k in KERNELS.items():
        groups = collections.defaultdict(dict)
        for mode, n in per_mode[name].items():
            if n:
                grade = mode.partition("/")[2]
                groups[f"{name}/{grade}" if grade else name][mode] = n
        for entry, counts in groups.items():
            mode = max(counts, key=counts.get)
            err = max(v for key, v in errs.items()
                      if key[0] == name and key[1] in counts
                      and key[2:] == (*k["shape"], "float32"))
            kernels.append(dict(name=entry,
                                mode=mode, route=k["route"],
                                source=k["source"], replaces=k["replaces"],
                                launches=sum(counts.values()),
                                max_abs_err=err, **times[(name, mode)]))
    # B.1's untrimmed residual, from phase 20's path (the TPU kernel's mode
    # at pallas_laplace.py:217)
    k = KERNELS["laplace"]
    kernels.append(dict(
        name="laplace/residual", mode="residual", route=k["route"],
        source=k["source"],
        replaces="portable_multigrid_tpu/ops/pallas_laplace.py:217",
        launches=residual_launches,
        max_abs_err=errs[("laplace", "residual", *k["shape"], "float32")],
        **times[("laplace", "residual")]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
