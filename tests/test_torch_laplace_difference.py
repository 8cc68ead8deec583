"""B.1's stiffness contractions in difference form, against the direct sum
of the TPU kernel, in float32.

    (K u)_i = sum_o K[i, i+o] (u_{i+o} - u_i) + s_i u_i

is the same operator as the direct banded sum.  But the float32 bands do
not sum to the row sums of K (zero away from the Dirichlet ends), so the
direct sum adds a spurious multiple of u of relative size eps / h^2 to the
operator: a smooth error that moves a CG solve's smooth solution and grows
4x per refinement (6.6e-5 in the L2 norm of the float32 Q4 r=6 solve).
The difference form carries the row sum itself and differences of
neighbouring values of a smooth u.  Measured along u (the energy
u . M A M u, the component that sets a smooth solution's norm), the
float32 twin must sit within 1e-7 of float64 and at least 10x closer than
the dense direct sum of the former twin; the whole vector differs from
float64 by the rounding noise of the float32 products, about the same in
both forms (within 1e-4 of the largest entry).
"""

import numpy as np
import pytest
import torch

from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_laplace import (
    apply_trimmed,
    make_cuda_laplace,
)
from portable_multigrid_tpu_torch.ops.structured import contract

torch.set_num_threads(1)


def dense(bands: torch.Tensor) -> torch.Tensor:
    """The [N, N] matrix of [2p+1, N] bands."""
    p = (bands.shape[0] - 1) // 2
    N = bands.shape[1]
    W = torch.zeros(N, N, dtype=bands.dtype)
    for o in range(-p, p + 1):
        i = torch.arange(max(0, -o), min(N, N - o))
        W[i, i + o] = bands[p + o, i]
    return W


def direct_sum(op, u: torch.Tensor) -> torch.Tensor:
    """M A M u by the dense trimmed matrices, K summed directly."""
    K, M = dense(op.kband), dense(op.mband)
    b, a = contract(u, M, 2), contract(u, K, 2)
    return (contract(contract(b, M, 1), K, 0)
            + contract(contract(b, K, 1) + contract(a, M, 1), M, 0))


@pytest.mark.parametrize("p,r", [(4, 3), (7, 2)])
def test_difference_form_keeps_the_smooth_component(p, r):
    sp = FESpace(HyperCubeMesh(3, r), p)
    op64 = make_cuda_laplace(sp, torch.float64)
    op32 = make_cuda_laplace(sp, torch.float32)
    N = op64.n * p
    s = np.sin(np.pi * np.arange(N) / N)
    u = torch.as_tensor(s[:, None, None] * s[None, :, None] * s[None, None, :])
    want = apply_trimmed(op64.kband, op64.ksum, op64.mband, u)
    u32 = u.float()
    got = {"difference": apply_trimmed(op32.kband, op32.ksum, op32.mband,
                                       u32).double(),
           "direct": direct_sum(op32, u32).double()}
    energy = float((u * want).sum())
    along_u = {k: abs(float((u * (g - want)).sum())) / energy
               for k, g in got.items()}
    whole = {k: float((g - want).abs().max() / want.abs().max())
             for k, g in got.items()}
    print(f"p={p} r={r}: error along u {along_u}, max error {whole}")
    assert along_u["difference"] <= 1e-7
    assert along_u["direct"] >= 10 * along_u["difference"]
    assert max(whole.values()) <= 1e-4
