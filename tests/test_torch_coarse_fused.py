"""The coarsest level's Chebyshev-as-solver on the kernel operator, fused
(``models/poisson.py`` ``_build_level``), on the CPU, where each kernel
wrapper runs its plain twin.

* On 2D p = 1 and on 3D p = 1..7 at the smallest meshes, in float32 and
  float64, the fused coarse ``apply`` equals the plain ``Chebyshev.apply``
  on the free DoFs to the dtype's rounding and is zero on the constrained
  ones; its degree, theta and delta are bit for bit the plain smoother's.
* The ``auto`` models give it trimmed state from the lowest transfer and,
  with it swapped back to the plain ``Chebyshev``, take the same CG count
  and land on the same L2 norm at rtol's grade.
* Traced, the coarse solve counts ``degree - 1`` passes of the cheb family
  (``pmg.laplace<dim>d.<mode>.p<degree>.n<cells>``) and no ``apply``, in
  the recorder and in the V-cycle's span plan.
"""

import dataclasses

import numpy as np
import pytest
import torch

from portable_multigrid_tpu_torch import (
    GeometricMultigridPoisson,
    MixedMultigridPoisson,
    MixedPrecisionPoisson,
    PolynomialMultigridPoisson,
)
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_laplace import make_cuda_laplace
from portable_multigrid_tpu_torch.ops.cuda_laplace2d import (
    make_cuda_laplace2d,
)
from portable_multigrid_tpu_torch.ops.transfer import (
    pad_last_planes,
    trim_last_planes,
)
from portable_multigrid_tpu_torch.solvers.chebyshev import (
    Chebyshev,
    FusedChebyshev,
    make_chebyshev,
)
from portable_multigrid_tpu_torch.utils import profiling

torch.set_num_threads(1)

# the dtype's rounding over a recurrence of up to 16 steps (3e-7 and 5e-16
# the largest read), relative to max |x|
ROUNDING = {torch.float32: 2e-6, torch.float64: 1e-14}
CHEB = ("chebd", "chebdl", "cheb", "chebl")


def coarse_pair(space, dtype):
    """(op, plain, fused): the kernel operator of ``space`` and its
    Chebyshev-as-solver both ways, with the model's coarse arguments."""
    make_op = {2: make_cuda_laplace2d, 3: make_cuda_laplace}[space.dim]
    op = make_op(space, dtype)
    kw = dict(smoothing_range=1e-3, degree=None,
              eig_cg_n_iterations=space.n_dofs)
    return op, make_chebyshev(op, **kw), make_chebyshev(op, fused=True, **kw)


def masked_rhs(op, seed):
    rng = np.random.default_rng(seed)
    b = torch.as_tensor(rng.standard_normal(op.shape), dtype=op.dtype)
    return b * op.mask


CASES = ([(2, 1, r) for r in (0, 1, 3)]
         + [(3, p, 0) for p in range(1, 8)] + [(3, 1, 2), (3, 3, 1)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dim,p,r", CASES)
def test_fused_coarse_apply_equals_plain(dim, p, r, dtype):
    op, plain, fused = coarse_pair(FESpace(HyperCubeMesh(dim, r), p), dtype)
    assert type(plain) is Chebyshev and type(fused) is FusedChebyshev
    assert fused.trimmed_io
    assert (fused.degree, fused.theta, fused.delta) == (
        plain.degree, plain.theta, plain.delta)
    b = masked_rhs(op, 10 * dim + p)
    want = trim_last_planes(plain.apply(b), dim)
    got = fused.apply(trim_last_planes(b, dim).contiguous())
    assert got.dtype == dtype and tuple(got.shape) == op.trimmed_shape
    free = trim_last_planes(op.mask, dim) != 0
    assert not got[~free].any()
    scale = float(want.abs().max())
    if not free.any():
        assert scale == 0.0  # Q1 on one cell: every DoF constrained
        return
    err = float((got - want).abs().max()) / scale
    assert err <= ROUNDING[dtype]


MODELS = {
    "2d_p": lambda dt: PolynomialMultigridPoisson(2, 3, 3, dtype=dt,
                                                  device="cpu"),
    "3d_h": lambda dt: GeometricMultigridPoisson(3, 3, 2, dtype=dt,
                                                 device="cpu"),
    "config3": lambda dt: MixedMultigridPoisson(3, 1, (1, 2), dtype=dt,
                                                device="cpu"),
    "config5": lambda dt: MixedPrecisionPoisson(3, 2, 2, dt, device="cpu"),
}


@pytest.mark.parametrize("kind", sorted(MODELS))
def test_lowest_transfer_speaks_trimmed_state(kind):
    """Every ``auto`` model's coarse solve takes trimmed state, and the
    transfer of the lowest pair gives it (the exact grade of the solve is
    held in tests/test_torch_bf16_counts.py)."""
    for dtype in (torch.float32, torch.float64):
        prob = MODELS[kind](dtype)
        sm = prob.levels[0].smoother
        assert type(sm) is FusedChebyshev and sm.trimmed_io
        assert prob.levels[1].transfer.coarse_trimmed


@dataclasses.dataclass
class PlainOnTrimmed:
    """The plain ``Chebyshev`` on the trimmed state that the fused coarse
    level speaks: padded to the full grid, solved, trimmed."""

    plain: Chebyshev

    def apply(self, bt):
        dim = self.plain.op.dim
        return trim_last_planes(self.plain.apply(pad_last_planes(bt, dim)),
                                dim).contiguous()


@pytest.mark.parametrize("dtype,rtol", [(torch.float32, 1e-5),
                                        (torch.float64, 1e-10)])
@pytest.mark.parametrize("kind", ["2d_p", "3d_h"])
def test_plain_coarse_swap_keeps_count_and_norm(kind, dtype, rtol):
    prob = MODELS[kind](dtype)
    _, fused = prob.solve(rtol=rtol)
    sm = prob.levels[0].smoother
    prob.levels = (dataclasses.replace(prob.levels[0], smoother=PlainOnTrimmed(
        Chebyshev(degree=sm.degree, op=sm.op, theta=sm.theta,
                  delta=sm.delta))),) + prob.levels[1:]
    _, plain = prob.solve(rtol=rtol)
    assert fused.converged and plain.converged
    assert fused.iterations == plain.iterations
    assert fused.solution_l2_norm == pytest.approx(plain.solution_l2_norm,
                                                   rel=rtol)


def coarse_counts(counts, op) -> dict:
    """The coarse operator's passes by mode, from a counter's keys."""
    key = f"pmg.laplace{op.dim}d."
    tail = f".p{op.degree}.n{op.n}"
    return {k[len(key):-len(tail)]: v for k, v in counts.items()
            if k.startswith(key) and k.endswith(tail)}


@pytest.mark.parametrize("kind", ["2d_p", "3d_h"])
def test_traced_coarse_solve_counts_its_passes(kind):
    prob = MODELS[kind](torch.float32)
    coarse = prob.levels[0]
    sm, op = coarse.smoother, coarse.op
    b = masked_rhs(op, 7)
    bt = trim_last_planes(b, op.dim).contiguous()
    with profiling.tracing() as rec:
        sm.apply(bt)
        mg = prob.preconditioner()
        mg.apply(prob.rhs())
    sm.apply(bt)  # tracing is off: counted nowhere
    solve = coarse_counts(rec.counts, op)
    assert solve.get("apply", 0) == 0
    assert set(solve) <= set(CHEB)
    # one coarse solve alone, then one in the V-cycle
    assert sum(solve.values()) == 2 * (sm.degree - 1)
    plan = rec.plans[-1]
    assert coarse_counts(plan.counts, op) == {
        k: v // 2 for k, v in solve.items()}
    assert sum(coarse_counts(plan.counts, op).values()) == sm.degree - 1
