"""Build the port's level objects from the JAX package's level state.

The JAX package's operators, transfers and smoothers hold their state as
separable 1D arrays and a few scalars.  Handed over as NumPy arrays (the
caller does ``np.asarray`` on the JAX side, so this module never sees JAX),
they rebuild the port's objects exactly, so a test can run both packages on
identical state and identical Chebyshev bounds:

  * operator: ``mask1``, ``dK1``, ``dM1`` and the assembled 1D ``K1``/``M1``
    (and ``G1``, ``mu``, ``lam`` for elasticity); for the other variants
    ``B``, ``Dco``, ``qmetric``, ``coef``, ``inv_diag_full``,
    ``elem_matrix``, ``Gmat`` and ``wcoef_e`` (``qbanded`` runs on ``B``,
    ``Dco`` and ``coef``: the JAX package's packed blocks of the same
    matrices are not carried over);
  * transfer: ``M1``, ``wmask_f`` and ``mask_c1`` of a ``Transfer``;
  * smoother: ``degree``, ``theta`` and ``delta``, and for a fused one its
    recurrence operator, its ``state_dtype`` and whether it has the
    ``cheb2lr`` kernel (``op_cheb2r``).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.cuda_cheb2 import make_cheb2
from .ops.cuda_laplace import CudaLaplaceOperator, cuda_laplace_from_factors
from .ops.cuda_elasticity import cuda_elasticity_from_factors
from .ops.cuda_laplace2d import CudaLaplace2D
from .ops.cuda_transfer import (
    CudaTransfer,
    _axis_matrix_1d,
    cuda_transfer_from_matrix,
)
from .ops.elasticity import elasticity_from_factors
from .ops.laplace import LaplaceOperator
from .ops.transfer import Transfer
from .solvers.chebyshev import Chebyshev, FusedChebyshev


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float64), dtype=dtype,
                           device=device)


def laplace_operator(*, degree: int, n: int, dim: int, mask1,
                     variant: str = "kron", dK1=None, dM1=None, K1=None,
                     M1=None, B=None, Dco=None, qmetric=None, coef=None,
                     inv_diag_full=None, elem_matrix=None, Gmat=None,
                     wcoef_e=None, dtype=torch.float64,
                     device="cpu") -> LaplaceOperator:
    """The plain operator of a variant from its state (1D factors identical
    on every axis); what the variant does not use stays None."""
    def t(a):
        return None if a is None else _t(a, dtype, device)

    def axes(a):
        return None if a is None else (t(a),) * dim

    return LaplaceOperator(
        dim=dim, degree=degree, n=(n,) * dim, mask1=axes(mask1),
        variant=variant, dK1=axes(dK1), dM1=axes(dM1), Kg=axes(K1),
        Mg=axes(M1), B=t(B), Dco=t(Dco), qmetric=t(qmetric), coef=t(coef),
        inv_diag_full=t(inv_diag_full), elem_matrix=t(elem_matrix),
        Gmat=t(Gmat), wcoef_e=t(wcoef_e))


def kernel_operator(*, degree: int, n: int, mask1, dK1, dM1, K1, M1,
                    dim: int = 3, dtype=torch.float64, device="cpu",
                    core: str = "banded") -> CudaLaplaceOperator:
    """The kernel operator from 1D state: B.1 in 3D (``core="mxu"``: its
    bf16 grade), B.4 in 2D."""
    cls = {2: CudaLaplace2D, 3: CudaLaplaceOperator}[dim]
    return cuda_laplace_from_factors(degree, n, mask1, K1, M1, dK1, dM1,
                                     dtype, device, cls=cls, core=core)


def elasticity_operator(*, degree: int, n: int, dim: int, mask1, dK1, dM1, mu,
                        lam, variant: str = "kron", K1=None, M1=None, G1=None,
                        B=None, Dco=None, qmetric=None, elem_matrix=None,
                        kernel: bool = False, dtype=torch.float64,
                        device="cpu", core: str = "banded"):
    """The elasticity operator from its state: a plain variant, or B.5 (3D,
    from the kron state) with ``kernel`` (``core="mxu"``: its bf16 grade,
    the JAX ``FusedVectorChebyshev``'s ``op_smooth``)."""
    if kernel:
        if dim != 3:
            raise ValueError("B.5 is a 3D operator")
        return cuda_elasticity_from_factors(degree, n, mask1, K1, M1, G1, dK1,
                                            dM1, float(mu), float(lam), dtype,
                                            device, core)
    return elasticity_from_factors(dim=dim, degree=degree, n=n, mu=float(mu),
                                   lam=float(lam), m1=mask1, gK=dK1, gM=dM1,
                                   variant=variant, K1=K1, M1=M1, G1=G1, B=B,
                                   Dco=Dco, qmetric=qmetric,
                                   elem_matrix=elem_matrix, dtype=dtype,
                                   device=device)


def plain_transfer(*, dim: int, n_coarse: int, stride_c: int, stride_f: int,
                   M1, wmask_f, mask_c1, dtype=torch.float64,
                   device="cpu") -> Transfer:
    return Transfer(dim=dim, n_coarse=(n_coarse,) * dim, stride_c=stride_c,
                    stride_f=stride_f, M1=_t(M1, dtype, device),
                    wmask_f=(_t(wmask_f, dtype, device),) * dim,
                    mask_c1=(_t(mask_c1, dtype, device),) * dim)


def kernel_transfer(*, n_coarse: int, stride_c: int, stride_f: int, M1,
                    wmask_f, mask_c1, coarse_trimmed: bool,
                    dtype=torch.float64, device="cpu") -> CudaTransfer:
    """The B.3 kernel transfer (3D) from a ``Transfer``'s 1D state."""
    P = _axis_matrix_1d(np.asarray(M1, np.float64), n_coarse, stride_c,
                        stride_f, np.asarray(wmask_f, np.float64),
                        np.asarray(mask_c1, np.float64))
    return cuda_transfer_from_matrix(P, dtype, device, coarse_trimmed)


def smoother(op, *, degree: int, theta, delta, fused: bool = False,
             op_smooth=None, state_dtype=None, op_cheb2r: bool = False):
    """A Chebyshev smoother with the given bounds: plain on the full grid,
    or fused on trimmed state (with the B.2 pair kernel where the operator
    has one, made from ``op_smooth`` when given).  ``op_smooth`` and
    ``state_dtype`` carry a JAX ``FusedChebyshev``'s (or
    ``FusedVectorChebyshev``'s) recurrence operator (e.g.
    :func:`kernel_operator` with ``core="mxu"``) and its ``state_dtype``
    (``"bf16"`` -> ``torch.bfloat16``); ``op_cheb2r`` True adds the
    ``cheb2lr`` kernel (``make_cheb2(..., rout=True)``) of a JAX
    smoother whose ``op_cheb2r`` is set."""
    theta, delta = float(np.asarray(theta)), float(np.asarray(delta))
    if state_dtype == "bf16":
        state_dtype = torch.bfloat16
    elif state_dtype == "f32":
        state_dtype = None
    if fused:
        pair_op = op if op_smooth is None else op_smooth
        return FusedChebyshev(degree=int(degree), op=op, theta=theta,
                              delta=delta,
                              op_cheb2=make_cheb2(pair_op) if op.pair_kernel
                              else None, op_smooth=op_smooth,
                              state_dtype=state_dtype,
                              op_cheb2r=make_cheb2(pair_op, rout=True)
                              if op_cheb2r else None)
    return Chebyshev(degree=int(degree), op=op, theta=theta, delta=delta)
