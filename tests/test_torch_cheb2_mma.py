"""B.2's tensor-core instance (``csrc/cheb2mma.cu``) on the CPU: its tile
and shared-memory formula, the instance each grade and dtype builds, and
the direct K sum that its bf16 ``mma`` tiles compute against the twin's
difference form.

No CUDA kernel runs here: ``tests/test_torch_cuda.py`` holds the instance
against ``cheb2_twin`` on the card.
"""

import numpy as np
import pytest
import torch

from portable_multigrid_tpu_torch import _build
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops import cuda_cheb2
from portable_multigrid_tpu_torch.ops.cuda_cheb2 import (
    MMA_SMEM_TWO,
    MODES,
    Cheb2Kernel,
    Cheb2RKernel,
    cheb2_mma_smem_bytes,
    cheb2_mma_tile,
    cheb2_tile,
    cheb2_twin,
    make_cheb2,
    make_cheb2_pencil,
    make_cheb2_xext,
)
from portable_multigrid_tpu_torch.ops.cuda_laplace import (
    SMEM_LIMIT,
    apply_trimmed,
    make_cuda_laplace,
)

torch.set_num_threads(1)

SM_SHARED = 228 * 1024  # an H100 SM's shared memory, 1 KB of it a block's


@pytest.mark.parametrize("p", range(1, 8))
def test_mma_tile_fits_shared_memory(p):
    """At every degree the tile launches: within 232,448 bytes of shared
    memory a block (twice within the SM where it claims two blocks), a
    grown column of 16, 24 or 32 rows in 8-row groups of two warps each, at
    most 1024 threads; the chunk is one of ceil(N / k) for k chunks."""
    for N in (2 * p, 8 * p, 64 * p):
        lx, ty, nw = cheb2_mma_tile(p, N)
        ey = ty + 2 * p
        assert ey in (16, 24, 32) and ty >= 1
        assert nw == 2 * (ey // 8 + -(-ty // 8)) and nw * 32 <= 1024
        smem = cheb2_mma_smem_bytes(p, ty)
        assert smem <= SMEM_LIMIT == 232448
        if smem <= MMA_SMEM_TWO:
            assert 2 * (smem + 1024) <= SM_SHARED
        assert 1 <= lx <= N and lx == -(-N // -(-N // lx))


def test_mma_tile_of_the_main_path():
    """Q4 r=6: 16 interior rows, 10 warps, two blocks an SM, the 256^3
    level in three chunks of 86 planes."""
    assert cheb2_mma_tile(4, 256) == (86, 16, 10)
    assert cheb2_mma_smem_bytes(4, 16) <= MMA_SMEM_TWO


class _Entries:
    """Stands in for the kernel library: an entry point is its name."""

    @staticmethod
    def fn(base, dtype_suffix=None):
        return base if dtype_suffix is None else f"{base}_{dtype_suffix}"


@pytest.mark.parametrize("core,dtype,rout,entry", [
    ("mxu", torch.float32, False, "pmg_cheb2mma"),
    ("banded", torch.float32, False, "pmg_cheb2_f32"),
    ("banded", torch.float64, False, "pmg_cheb2_f64"),
    ("mxu", torch.float64, False, None),
    ("mxu", torch.float32, True, None),
    ("banded", torch.float32, True, None),
])
def test_engine_is_a_function_of_grade_and_dtype(monkeypatch, core, dtype,
                                                 rout, entry):
    """The operator's core picks the pair's instance: the production grade
    (mxu, float32 only: make_cuda_laplace refuses it in float64) launches
    the tensor cores with their tile, the exact grade the CUDA cores with
    theirs; cheb2lr is a kernel of its own on the CUDA cores at either
    grade."""
    monkeypatch.setattr(_build, "build", lambda: _Entries)
    p = 2
    sp = FESpace(HyperCubeMesh(3, 3), p)
    if core == "mxu" and dtype == torch.float64:
        with pytest.raises(ValueError, match="float32"):
            make_cuda_laplace(sp, dtype, core=core)
        return
    op = make_cuda_laplace(sp, dtype, core=core)
    N = op.n * p
    itemsize = torch.empty((), dtype=dtype).element_size()
    kern = make_cheb2(op, rout)
    if rout:
        assert isinstance(kern, Cheb2RKernel)
        assert kern.tile == cheb2_tile(p, itemsize, N, rout=True)
        return
    assert isinstance(kern, Cheb2Kernel)
    assert kern.tile == (cheb2_mma_tile(p, N) if core == "mxu"
                         else cheb2_tile(p, itemsize, N))
    assert kern.kernel_fn() == entry


@pytest.mark.parametrize("core,dtype", [("mxu", torch.float32),
                                        ("banded", torch.float32),
                                        ("banded", torch.float64)])
def test_kernels_take_the_engine_and_its_tile(monkeypatch, core, dtype):
    """make_cheb2, make_cheb2_xext and make_cheb2_pencil build the pair on
    the instance of the operator's core, with that instance's tile; the
    cheb2lr kernel keeps the CUDA-core tile."""
    monkeypatch.setattr(_build, "build", lambda: _Entries)
    p, r = 2, 3
    op = make_cuda_laplace(FESpace(HyperCubeMesh(3, r), p), dtype,
                           core=core)
    N = op.n * p
    itemsize = torch.empty((), dtype=dtype).element_size()
    kern = make_cheb2(op)
    assert isinstance(kern, Cheb2Kernel)
    want = (cheb2_mma_tile(p, N) if core == "mxu"
            else cheb2_tile(p, itemsize, N))
    assert kern.tile == want
    shard = make_cheb2_xext(op, N // 4, N // 4)
    pencil = make_cheb2_pencil(op, 0, N // 2, N // 2, N // 2)
    assert shard.kernel_fn() == pencil.kernel_fn() == kern.kernel_fn()
    if core == "mxu":
        assert shard.tile == cheb2_mma_tile(p, N, nx=N // 4)
        assert pencil.tile == cheb2_mma_tile(p, N, nx=N // 2, ny=N // 2)
    rk = make_cheb2(op, rout=True)
    assert isinstance(rk, Cheb2RKernel)
    assert rk.tile == cheb2_tile(p, itemsize, N, rout=True)


def test_mma_counter_counts_no_cpu_pass():
    """On a CPU tensor the production-grade pair runs the twin, and no
    LAUNCHES key moves."""
    assert set(cuda_cheb2.LAUNCHES) >= set(MODES)
    op = make_cuda_laplace(FESpace(HyperCubeMesh(3, 2), 2), torch.float32,
                           core="mxu")
    N = op.n * 2
    rng = np.random.default_rng(0)
    d, r, x = (torch.as_tensor(rng.standard_normal((N,) * 3),
                               dtype=torch.float32) for _ in range(3))
    before = dict(cuda_cheb2.LAUNCHES)
    scal = (0.59, 1.26, 0.71, 1.52)
    got = make_cheb2(op).steps2(d, r, x, scal, "cheb2")
    want = cheb2_twin(op, d, r, x, scal, "cheb2")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert dict(cuda_cheb2.LAUNCHES) == before


@pytest.mark.parametrize("p", [1, 4, 7])
def test_direct_k_sum_at_the_bf16_grade(p):
    """The tensor-core instance sums K directly: in float64 the direct and
    the difference form are one operator (K's row sums are those of its
    bands); at the bf16 grade in float32 the direct sum lands within the
    bound that the on-card tests hold the kernel to (1e-2 of the max)
    of the twin's difference form, and on most points far closer."""
    rng = np.random.default_rng(p)
    sp = FESpace(HyperCubeMesh(3, 2), p)
    N = 4 * p
    mask = np.ones(N)
    mask[0] = 0.0
    u = rng.standard_normal((N,) * 3) * np.einsum("i,j,k->ijk", mask, mask,
                                                  mask)
    op64 = make_cuda_laplace(sp, torch.float64)
    u64 = torch.as_tensor(u)
    diff = apply_trimmed(op64.kband, op64.ksum, op64.mband, u64)
    direct = apply_trimmed(op64.kband, None, op64.mband, u64)
    scale = float(diff.abs().max())
    assert float((direct - diff).abs().max()) <= 1e-12 * scale
    op = make_cuda_laplace(sp, torch.float32, core="mxu")
    u32 = u64.to(torch.float32)
    diff = apply_trimmed(op.kband, op.ksum, op.mband, u32, True)
    direct = apply_trimmed(op.kband, None, op.mband, u32, True)
    err = (direct - diff).abs() / float(diff.abs().max())
    assert float(err.max()) <= 1e-2
    assert float((err > 2.0 ** -18).double().mean()) <= 5e-2
