"""The yardstick of the roofline metrics: the H100's published peaks and
the work of one fine-level operator application, counted from the
algorithm and the shapes, never from a kernel's mode.

Peaks: NVIDIA's data sheet of the H100 SXM part (dense rates), at its full
700 W; the run prints the card's own power limit beside them.

Work of one application of the Q_p Laplace operator on 2^r cells per axis
in ``dim`` dimensions, with n = p + 1 Gauss points per axis:

  * bytes: the vector CG hands the operator, read once, and the result,
    written once, at the solve's dtype;
  * FMAs: deal.II's sum-factorised cell operator (``FEEvaluation``:
    values to the quadrature points, collocation gradients, and the
    transposes back: 4 dim sweeps of n^(dim - 1) lines a cell), each 1D
    line of n to n points in the even-odd form that deal.II uses, which
    takes n * ceil(n / 2) FMAs, plus dim products a quadrature point for
    the Cartesian metric; times the number of cells.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ITEMSIZE = {"float32": 4, "float64": 8}


def n_dofs(dim: int, degree: int, refinements: int) -> int:
    return ((1 << refinements) * degree + 1) ** dim


def line_fmas(n: int) -> int:
    """FMAs of one even-odd 1D contraction of n points to n points."""
    return n * ((n + 1) // 2)


def cell_fmas(dim: int, degree: int) -> int:
    n = degree + 1
    return 4 * dim * n ** (dim - 1) * line_fmas(n) + dim * n ** dim


def fine_apply_fmas(dim: int, degree: int, refinements: int) -> int:
    return (1 << (refinements * dim)) * cell_fmas(dim, degree)


def fine_apply_bytes(dim: int, degree: int, refinements: int,
                     dtype: str) -> int:
    return 2 * n_dofs(dim, degree, refinements) * ITEMSIZE[dtype]


def fine_apply_bound_s(dim: int, degree: int, refinements: int,
                       dtype: str) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time one fine-level
    application could take on the card."""
    t_bytes = (fine_apply_bytes(dim, degree, refinements, dtype)
               / HBM_BYTES_PER_S)
    t_ops = 2 * fine_apply_fmas(dim, degree, refinements) / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
