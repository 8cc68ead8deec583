"""B.4: the fused banded 2D Laplace operator (``csrc/laplace2d.cu``) and its
twin.

Counterpart of ``portable_multigrid_tpu/ops/pallas_laplace2d.py``
(``PallasLaplace2D``, ``make_pallas_laplace2d``), the operator of every
level of the reference's second driver.  It works on TRIMMED state — the
global last row and column dropped, shape (n p)^2, C order with y
contiguous — and computes M A M u with

    A = Kx (x) My + Mx (x) Ky

from the GLOBAL mask-folded 1D matrices, plus the single-step Chebyshev
epilogues of the TPU kernel (modes in :data:`MODES`, the same as B.1's).

Each stiffness contraction runs in difference form,

    (K u)_i = sum_o K[i, i+o] (u_{i+o} - u_i) + s_i u_i,

with s_i the row sum of the mask-folded K, taken on the host from the
entries the mask removes (the rows of the assembled K sum to zero, so s
is zero away from the Dirichlet ends).  It is the same operator; in f32 it
keeps the solution at the mesh-converged value where the direct banded sum
of the TPU kernel does not: the direct sum loses the small K u of a smooth
u to cancellation, an error that grows 4x per refinement (3.4% of the L2
norm at Q7 r=9), while the differences of neighbouring values are small
and nearly exact.

The recurrence streams may be stored in bfloat16 (``sdtype``, the TPU
kernel's ``sdtype="bf16"``, ``pallas_laplace2d.py:30-32``): the operator
stays exact, as in the JAX package, which has no bf16 core in 2D.

Every mode takes trimmed state, "apply" included (the TPU kernel took the
full grid there; :meth:`CudaLaplace2D.apply` trims and pads around it).
There is no untrimmed "residual" mode, as in the TPU kernel; asking for it
raises ``ValueError``.  On a CUDA tensor :meth:`CudaLaplace2D.run` launches
the hand-written kernel; on a CPU tensor it runs :func:`laplace2d_twin`,
the plain torch banded form of the same modes and outputs.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import torch

from ..fem.space import FESpace
from .cuda_laplace import (
    MODES,
    SMEM_LIMIT,
    CudaLaplaceOperator,
    banded,
    chunk_planes,
    cuda_laplace_from_factors,
    twin_epilogue,
)
from .laplace import (
    assembled_1d_matrices,
    diagonal_1d_factors,
    separable_diagonal,
)

# kernel launches per mode, counted where the wrapper launches the kernel
LAUNCHES = dict.fromkeys(MODES, 0)

NW = 4  # warps of a block, one y point a thread (kNW in laplace2d.cu)
STAGES = 4  # buffer sets of the row pipeline, STAGES - 1 rows ahead (kStages)


def laplace2d_blocks(itemsize: int) -> int:
    """Blocks an SM holds at once (kBlocks in laplace2d.cu, the register
    cap of its launch bounds): 4 in float32, 2 in float64."""
    return 4 if itemsize == 4 else 2


def laplace2d_smem_elems(p: int, ty: int) -> int:
    """Shared-memory elements of one block (mirrors smem_elems in
    laplace2d.cu): STAGES buffer sets of the u row with its halo of p a
    side (rounded up to a multiple of four), the x row (2(2p+1) + 3 values,
    rounded likewise) and the epilogue's three inputs on the column."""
    def up4(n):
        return -(-n // 4) * 4

    return STAGES * (up4(ty + 2 * p) + up4(4 * p + 5) + 3 * ty)


def laplace2d_tile(p: int, itemsize: int, N: int) -> tuple[int, int, int]:
    """(LX, TY, NW) of the B.4 launch for an N^2 grid, as laplace2d.cu
    compiles it: columns of TY = 32 NW y points and x chunks of LX rows
    with 2p lead-in rows, cut for :func:`laplace2d_blocks` blocks per SM."""
    ty, per_sm = 32 * NW, laplace2d_blocks(itemsize)
    if per_sm * laplace2d_smem_elems(p, ty) * itemsize > SMEM_LIMIT:
        raise ValueError(f"no laplace2d tile fits shared memory at p={p}")
    return chunk_planes(N, -(-N // ty), 2 * p, per_sm), ty, NW


def apply_trimmed_2d(kband: torch.Tensor, ksum: torch.Tensor,
                     mband: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """M A M u on trimmed 2D state: Kx (My u) + Mx (Ky u), the stiffness
    contractions in difference form."""
    return (banded(banded(u, mband, 1), kband, 0, ksum)
            + banded(banded(u, kband, 1, ksum), mband, 0))


@dataclasses.dataclass
class CudaLaplace2D(CudaLaplaceOperator):
    """2D Q_p Laplace operator for the kernel path, on one device: the
    surface of the 3D operator, with ``tile`` = (LX, TY, NW) of
    :func:`laplace2d_tile`."""

    dim: int = 2
    kernel: ClassVar[str] = "pmg_laplace2d"
    launches: ClassVar[dict] = LAUNCHES
    pair_kernel: ClassVar[bool] = False
    full_modes: ClassVar[tuple] = ()

    def diag_trimmed(self) -> torch.Tensor:
        """dKx dMy + dMx dKy on the trimmed grid (raw values on constrained
        entries, as the kernel rebuilds it)."""
        return separable_diagonal((self.dKt,) * 2, (self.dMt,) * 2)

    def raw_twin(self, mode: str, u: torch.Tensor, ins=(), scal=()):
        return laplace2d_twin(self, mode, u, ins, scal)

    @staticmethod
    def pick_tile(p: int, itemsize: int, N: int) -> tuple:
        return laplace2d_tile(p, itemsize, N)

    def kernel_state(self) -> tuple:
        return self.kband, self.ksum, self.mband, self.dK1, self.dM1

    def kernel_sizes(self) -> tuple:
        return (self.n * self.degree,)


def laplace2d_twin(op: CudaLaplace2D, mode: str, u: torch.Tensor, ins=(),
                   scal=()):
    """Plain torch version of every kernel mode, in the operator's dtype."""
    return twin_epilogue(op, mode,
                         apply_trimmed_2d(op.kband, op.ksum, op.mband, u),
                         u, ins, scal)


def cuda_laplace2d_from_factors(degree: int, n: int, m1, K1, M1, gK, gM,
                                dtype=torch.float32,
                                device="cpu") -> CudaLaplace2D:
    """Pack the 2D operator from its 1D factors (NumPy, float64), as
    :func:`~.cuda_laplace.cuda_laplace_from_factors` packs the 3D one."""
    return cuda_laplace_from_factors(degree, n, m1, K1, M1, gK, gM, dtype,
                                     device, cls=CudaLaplace2D)


def make_cuda_laplace2d(space: FESpace, dtype=torch.float32,
                        device="cpu") -> CudaLaplace2D:
    """Host packing (NumPy, f64) of the 1D factors, shipped once to ``device``."""
    if space.dim != 2:
        raise ValueError("B.4 is the 2D operator; make_cuda_laplace builds "
                         "the 3D one")
    K1, M1 = assembled_1d_matrices(space)
    gK, gM = diagonal_1d_factors(space)
    return cuda_laplace2d_from_factors(
        space.degree, space.mesh.cells_per_axis, space.free_mask_1d(), K1, M1,
        gK, gM, dtype, device)
