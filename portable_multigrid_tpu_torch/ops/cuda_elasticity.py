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
    CudaLaplaceOperator,
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
# (TX, TY, TZ) candidates; TZ, TY TZ and TX TZ divide the 256 threads
_TILES = ((8, 8, 32), (8, 8, 16), (4, 4, 16), (4, 4, 8), (2, 2, 8))
_GROUPS = 6  # y-stage groups of one input component


def elasticity_smem_elems(p: int, tx: int, ty: int, tz: int) -> int:
    """Shared-memory elements of one block (mirrors smem_elems in
    elasticity.cu): the window or the groups it turns into, the four z
    products and the three output accumulators."""
    wx, wy, wz = tx + 2 * p, ty + 2 * p, tz + 2 * p
    return (max(wx * wy * wz, _GROUPS * wx * ty * tz) + 4 * wx * wy * tz
            + 3 * tx * ty * tz)


def elasticity_tile(p: int, itemsize: int) -> tuple[int, int, int]:
    """The largest candidate tile that leaves room for two blocks per SM,
    else the largest that fits one."""
    sizes = [(elasticity_smem_elems(p, *t) * itemsize, t) for t in _TILES]
    for limit in (SMEM_BUDGET, SMEM_LIMIT):
        fits = [t for b, t in sizes if b <= limit]
        if fits:
            return fits[0]
    raise ValueError(f"no elasticity tile fits shared memory at p={p}")


def row_sums(W1: np.ndarray, m1: np.ndarray) -> np.ndarray:
    """Row sums of the trimmed mask-folded (m W1 m)[:-1, :-1], from the
    entries the mask removes: the free rows of the assembled K, G and G^T
    sum to zero, so free row i sums to -sum_j W1[i, j] (1 - m_j), with no
    cancellation (constrained rows are zero)."""
    return (-m1 * (W1 @ (1.0 - m1)))[:-1]


@dataclasses.dataclass
class CudaElasticityOperator(CudaLaplaceOperator):
    """3D Q_p elasticity operator for the kernel path, on one device: the
    surface of the B.1 operator on [3, ...] fields, ``kband``/``mband`` plus
    the G and H bands, the row sums of K, G, H, and mu / lam."""

    mu: float = 1.0
    lam: float = 1.0
    gband: torch.Tensor = None  # [2p+1, N-1] bands of the trimmed folded G
    hband: torch.Tensor = None  # [2p+1, N-1] bands of its transpose
    ksum: torch.Tensor = None  # [N-1] row sums of the trimmed folded K
    gsum: torch.Tensor = None  # ... of G
    hsum: torch.Tensor = None  # ... of G^T
    Gt: torch.Tensor = None  # [N-1, N-1] trimmed mask-folded G (twin)
    kernel: ClassVar[str] = "pmg_elasticity"
    launches: ClassVar[dict] = LAUNCHES
    pair_kernel: ClassVar[bool] = False

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

    def twin(self, mode: str, u: torch.Tensor, ins=(), scal=()):
        return elasticity_twin(self, mode, u, ins, scal)

    @staticmethod
    def pick_tile(p: int, itemsize: int) -> tuple:
        return elasticity_tile(p, itemsize)

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
        tile=elasticity_tile(degree, itemsize), Kt=t(Kt), Mt=t(Mt),
        mu=float(mu), lam=float(lam),
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
