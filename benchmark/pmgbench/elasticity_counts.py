"""The yardstick of the elasticity roofline metrics: the work of one
application of the vector Q_p linear elasticity operator at a level, and
the applications that a level's smoothing makes per V-cycle, counted from
the algorithm and the shapes, never from a kernel's mode.  Peaks as in
``counts.py``.

Work of one application on 2^r cells per axis in ``dim`` dimensions, dim
displacement components, n = p + 1 Gauss points per axis:

  * bytes: the dim-component vector CG hands the operator, read once, and
    the result, written once, at the solve's dtype: 2 dim (2^r p + 1)^dim
    items;
  * FMAs: deal.II's vector ``FEEvaluation``: for each component, values to
    the quadrature points, collocation gradients and the transposes back,
    4 dim sweeps of n^(dim - 1) lines, each line in the even-odd form at
    n ceil(n / 2) FMAs (``counts.line_fmas``); then at each quadrature
    point the stress: 2 dim^2 products for the Cartesian metric (the
    gradient in, the test gradient out, JxW folded in), dim for the
    divergence and dim (dim + 1) / 2 for the symmetric stress mu (grad u +
    grad u^T) + lam (div u) I.  A cell:

        dim * 4 dim * n^(dim - 1) * n ceil(n / 2)
            + n^dim * (2 dim^2 + dim + dim (dim + 1) / 2),

    at Q3 in 3D (n = 4): 3 * 12 * 16 * 8 + 64 * 27 = 4608 + 1728 = 6336;
    times 2^(r dim) cells.

Applications a smoothing level makes per V-cycle, V(pre, post) with
Chebyshev smoothing of ``degree`` (the reference program's
PreconditionChebyshev, ``program.cc:259-287``: degree 5, V(2,2)): a
smoothing step is degree operator applications, one for its residual and
degree - 1 for the recurrence; the first pre-smoothing step starts from
zero and skips its residual, and the last one's residual is the one the
V-cycle restricts, so a level makes (pre + post) degree applications:
(pre + post) (degree - 1) recurrence steps and pre + post residuals.
"""

from __future__ import annotations

from .counts import HBM_BYTES_PER_S, ITEMSIZE, PEAK_FLOPS, line_fmas, n_dofs

# the deployment's smoother (program.cc:259-287) and cycle
CHEBYSHEV_DEGREE = 5
PRE_SMOOTHING = POST_SMOOTHING = 2


def cell_fmas(dim: int, degree: int) -> int:
    n = degree + 1
    sweeps = dim * 4 * dim * n ** (dim - 1) * line_fmas(n)
    return sweeps + n ** dim * (2 * dim * dim + dim + dim * (dim + 1) // 2)


def apply_fmas(dim: int, degree: int, refinements: int) -> int:
    return (1 << (refinements * dim)) * cell_fmas(dim, degree)


def apply_bytes(dim: int, degree: int, refinements: int, dtype: str) -> int:
    return 2 * dim * n_dofs(dim, degree, refinements) * ITEMSIZE[dtype]


def apply_bound_s(dim: int, degree: int, refinements: int,
                  dtype: str) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time one application
    at the level of 2^refinements cells per axis could take on the card."""
    t_bytes = apply_bytes(dim, degree, refinements, dtype) / HBM_BYTES_PER_S
    t_ops = 2 * apply_fmas(dim, degree, refinements) / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def smoothing_applications(degree: int = CHEBYSHEV_DEGREE,
                           pre: int = PRE_SMOOTHING,
                           post: int = POST_SMOOTHING) -> dict[str, int]:
    """The operator applications one V-cycle's smoothing makes at a level,
    by kind: ``recurrence`` (Chebyshev steps) and ``residual``."""
    return {"recurrence": (pre + post) * (degree - 1),
            "residual": pre + post}
