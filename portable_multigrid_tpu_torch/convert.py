"""Build the port's level objects from the JAX package's level state.

The JAX package's operators, transfers and smoothers hold their state as
separable 1D arrays and a few scalars.  Handed over as NumPy arrays (the
caller does ``np.asarray`` on the JAX side, so this module never sees JAX),
they rebuild the port's objects exactly, so a test can run both packages on
identical state and identical Chebyshev bounds:

  * operator: ``mask1``, ``dK1``, ``dM1`` and the assembled 1D ``K1``/``M1``
    (and ``G1``, ``mu``, ``lam`` for elasticity);
  * transfer: ``M1``, ``wmask_f`` and ``mask_c1`` of a ``Transfer``;
  * smoother: ``degree``, ``theta`` and ``delta``.
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


def kron_operator(*, degree: int, n: int, dim: int, mask1, dK1, dM1, K1, M1,
                  dtype=torch.float64, device="cpu") -> LaplaceOperator:
    """The plain Kronecker operator from 1D state (identical on every axis)."""
    t = lambda a: (_t(a, dtype, device),) * dim
    return LaplaceOperator(dim=dim, degree=degree, n=(n,) * dim,
                           mask1=t(mask1), dK1=t(dK1), dM1=t(dM1), Kg=t(K1),
                           Mg=t(M1))


def kernel_operator(*, degree: int, n: int, mask1, dK1, dM1, K1, M1,
                    dim: int = 3, dtype=torch.float64,
                    device="cpu") -> CudaLaplaceOperator:
    """The kernel operator from 1D state: B.1 in 3D, B.4 in 2D."""
    cls = {2: CudaLaplace2D, 3: CudaLaplaceOperator}[dim]
    return cuda_laplace_from_factors(degree, n, mask1, K1, M1, dK1, dM1,
                                     dtype, device, cls=cls)


def elasticity_operator(*, degree: int, n: int, dim: int, mask1, dK1, dM1, K1,
                        M1, G1, mu, lam, kernel: bool = False,
                        dtype=torch.float64, device="cpu"):
    """The elasticity operator from 1D state: the plain Kronecker one, or
    B.5 (3D) with ``kernel``."""
    if kernel:
        if dim != 3:
            raise ValueError("B.5 is a 3D operator")
        return cuda_elasticity_from_factors(degree, n, mask1, K1, M1, G1, dK1,
                                            dM1, float(mu), float(lam), dtype,
                                            device)
    return elasticity_from_factors(dim=dim, degree=degree, n=n, mu=float(mu),
                                   lam=float(lam), m1=mask1, gK=dK1, gM=dM1,
                                   K1=K1, M1=M1, G1=G1, dtype=dtype,
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


def smoother(op, *, degree: int, theta, delta, fused: bool = False):
    """A Chebyshev smoother with the given bounds: plain on the full grid,
    or fused on trimmed state (with the B.2 pair kernel where the operator
    has one)."""
    theta, delta = float(np.asarray(theta)), float(np.asarray(delta))
    if fused:
        return FusedChebyshev(degree=int(degree), op=op, theta=theta,
                              delta=delta,
                              op_cheb2=make_cheb2(op) if op.pair_kernel
                              else None)
    return Chebyshev(degree=int(degree), op=op, theta=theta, delta=delta)
