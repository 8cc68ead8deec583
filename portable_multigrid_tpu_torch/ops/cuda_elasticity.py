"""B.5: the fused banded elasticity operator (``csrc/elasticity.cu``) and its
twin.

Counterpart of ``portable_multigrid_tpu/ops/pallas_elasticity.py``
(``PallasElasticityOperator``, ``make_pallas_elasticity``; the exact
"banded" core with the structural x mask).  The operator works on TRIMMED
3-component state — [3, n p, n p, n p], the global last plane of every
spatial axis dropped, C order with z contiguous — and computes M A M u for
the 21 Kronecker chains of the elasticity weak form (``ops/elasticity.py``)
from the GLOBAL mask-folded trimmed 1D matrices K, M, G and H = G^T, plus
the single-step Chebyshev epilogues of B.1 (modes in :data:`MODES`) with the
per-component diagonal diag_c = sum_k alpha_{k,c} (dK@k, dM elsewhere).

The TPU modes map to the port's: ``apply`` -> ``apply`` (trimmed in and
out; :meth:`~.cuda_laplace.CudaLaplaceOperator.apply` trims and pads around
it), ``residual1`` -> ``residual1t``, ``residual`` -> ``residual3t`` (which
also writes x0 = u + d0), ``cheb``/``chebl`` -> ``cheb``/``chebl``, and the
port's ``chebd``/``chebdl`` take x == d on entry.  The kernel sums every K,
G and H contraction in difference form with the row sums below; the twin
contracts the dense matrices directly.  On a CUDA tensor
:meth:`~.cuda_laplace.CudaLaplaceOperator.run` launches the kernel; on a
CPU tensor it runs :func:`elasticity_twin`.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch

from ..fem.space import FESpace
from .cuda_laplace import (
    MODES,
    SMEM_LIMIT,
    SMS,
    CudaLaplaceOperator,
    row_sums,
    to_bands,
    twin_epilogue,
)
from .elasticity import (
    assembled_1d_gradient,
    elasticity_inv_diag,
    elasticity_kron,
    separable_elasticity_diagonal,
)
from .laplace import assembled_1d_matrices, diagonal_1d_factors

# kernel launches per mode, counted where the wrapper launches the kernel
LAUNCHES = dict.fromkeys(MODES, 0)

SMEM_BUDGET = 113 * 1024  # two blocks per SM
TZ = 32  # z extent of a block's column: one warp (kTZ in elasticity.cu)
_TY = (8, 4, 2, 1)  # candidate y extents; a block is 32 TY threads
_LX = (64, 48, 32, 16, 8, 4, 2)  # candidate x chunks (output planes a block)
_GROUPS = 12  # (output, x matrix) groups in the ring


def elasticity_smem_elems(p: int, ty: int) -> int:
    """Shared-memory elements of one block (mirrors smem_elems in
    elasticity.cu): two windows of the three components, two sets of the
    four z products, and the ring of 2p+1 planes of 12 groups."""
    wy, wz = ty + 2 * p, TZ + 2 * p
    return 2 * 3 * wy * wz + 2 * 4 * wy * TZ + (2 * p + 1) * _GROUPS * ty * TZ


def elasticity_tile(p: int, itemsize: int, N: int) -> tuple[int, int, int]:
    """(LX, TY, TZ) of the launch for an N^3 grid.

    TY: the largest that leaves room for two blocks per SM in float32 (the
    kernel's register bound assumes two), else the largest that fits one.
    LX: a block marches LX + 2p planes one after the other (the chunk and
    its lead-in), and the grid runs in waves of the blocks the SMs hold at
    once, so the chunk minimises waves x (LX + 2p), ties to the larger
    chunk: 64 at 3 x 192^3 (Q3 r=6), 2 on the small levels, where the
    march is the whole time of a launch."""
    limits = (SMEM_BUDGET, SMEM_LIMIT) if itemsize == 4 else (SMEM_LIMIT,)
    # at p >= 4 a block has at most 128 threads (kMaxThreads in the kernel)
    ty = next((t for limit in limits for t in _TY
               if elasticity_smem_elems(p, t) * itemsize <= limit
               and (p <= 3 or t <= 4)), None)
    if ty is None:
        raise ValueError(f"no elasticity tile fits shared memory at p={p}")
    two = itemsize == 4 and elasticity_smem_elems(p, ty) * 4 <= SMEM_BUDGET
    resident = SMS * (2 if two else 1)
    columns = -(-N // TZ) * -(-N // ty)

    def cost(lx):
        return -(-columns * -(-N // lx) // resident) * (lx + 2 * p)

    return min(_LX, key=lambda lx: (cost(lx), -lx)), ty, TZ


@dataclasses.dataclass
class CudaElasticityOperator(CudaLaplaceOperator):
    """3D Q_p elasticity operator for the kernel path, on one device: the
    surface of the B.1 operator on [3, ...] fields, ``kband``/``mband`` plus
    the G and H bands, the row sums of K, G, H, and mu / lam."""

    mu: float = 1.0
    lam: float = 1.0
    gband: torch.Tensor = None  # [2p+1, N-1] bands of the trimmed folded G
    hband: torch.Tensor = None  # [2p+1, N-1] bands of its transpose
    gsum: torch.Tensor = None  # ... of G
    hsum: torch.Tensor = None  # ... of G^T
    # [N-1, N-1] trimmed mask-folded K, M and G (twin)
    Kt: torch.Tensor = None
    Mt: torch.Tensor = None
    Gt: torch.Tensor = None
    kernel: ClassVar[str] = "pmg_elasticity"
    launches: ClassVar[dict] = LAUNCHES
    pair_kernel: ClassVar[bool] = False
    # B.5 stores every stream in its dtype (its bf16 core is not ported)
    bf16_state: ClassVar[bool] = False

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.dim,) + self.grid_shape

    @property
    def trimmed_shape(self) -> tuple[int, ...]:
        return (self.dim,) + (self.n * self.degree,) * self.dim

    @property
    def inv_diag(self) -> torch.Tensor:
        return elasticity_inv_diag(self)

    def diag_trimmed(self) -> torch.Tensor:
        """[3, ...] diagonal on the trimmed grid (raw values on constrained
        entries, as the kernel rebuilds it)."""
        return separable_elasticity_diagonal(self.dKt, self.dMt, self.mu,
                                             self.lam, self.dim)

    def raw_twin(self, mode: str, u: torch.Tensor, ins=(), scal=()):
        return elasticity_twin(self, mode, u, ins, scal)

    def kernel_state(self) -> tuple:
        return (self.kband, self.ksum, self.mband, self.gband, self.gsum,
                self.hband, self.hsum, self.dK1, self.dM1)

    def kernel_scalars(self) -> tuple:
        return float(self.mu), float(self.lam)


def elasticity_twin(op: CudaElasticityOperator, mode: str, u: torch.Tensor,
                    ins=(), scal=()):
    """Plain torch version of every kernel mode (same inputs and outputs):
    the dense trimmed mask-folded 1D matrices contracted directly."""
    raw = elasticity_kron(u, op.Kt, op.Mt, op.Gt, op.Gt.T, op.mu, op.lam)
    return twin_epilogue(op, mode, raw, u, ins, scal)


def cuda_elasticity_from_factors(degree: int, n: int, m1, K1, M1, G1, gK, gM,
                                 mu: float, lam: float, dtype=torch.float32,
                                 device="cpu") -> CudaElasticityOperator:
    """Pack the operator from its 1D factors (NumPy, float64): the free-DoF
    mask ``m1``, the assembled 1D matrices ``K1``/``M1``/``G1`` and the
    diagonal factors ``gK`` (h-folded) / ``gM``, all of length n*degree+1."""
    m1, K1, M1, G1 = (np.asarray(a, np.float64) for a in (m1, K1, M1, G1))

    def fold(W):
        return (m1[:, None] * W * m1[None, :])[:-1, :-1]

    def t(a):
        return torch.as_tensor(np.array(a, np.float64), dtype=dtype,
                               device=device)

    Kt, Mt, Gt = fold(K1), fold(M1), fold(G1)
    itemsize = torch.empty((), dtype=dtype).element_size()
    return CudaElasticityOperator(
        degree=degree, n=n, mask1=t(m1), dK1=t(gK), dM1=t(gM),
        kband=t(to_bands(Kt, degree)), mband=t(to_bands(Mt, degree)),
        tile=elasticity_tile(degree, itemsize, n * degree),
        Kt=t(Kt), Mt=t(Mt), mu=float(mu), lam=float(lam),
        gband=t(to_bands(Gt, degree)), hband=t(to_bands(Gt.T, degree)),
        ksum=t(row_sums(K1, m1)), gsum=t(row_sums(G1, m1)),
        hsum=t(row_sums(G1.T, m1)), Gt=t(Gt))


def make_cuda_elasticity(space: FESpace, dtype=torch.float32, mu: float = 1.0,
                         lam: float = 1.0,
                         device="cpu") -> CudaElasticityOperator:
    """Host packing (NumPy, f64) of the 1D factors, shipped once to ``device``."""
    if space.dim != 3:
        raise ValueError("B.5 is a 3D operator; the plain 'kron' "
                         "elasticity operator serves 2D")
    K1, M1 = assembled_1d_matrices(space)
    gK, gM = diagonal_1d_factors(space)
    return cuda_elasticity_from_factors(
        space.degree, space.mesh.cells_per_axis, space.free_mask_1d(), K1, M1,
        assembled_1d_gradient(space), gK, gM, mu, lam, dtype, device)
