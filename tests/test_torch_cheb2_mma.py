"""B.2's tensor-core instance (``csrc/cheb2mma.cu``) on the CPU: its tile
and shared-memory formula, the engine each grade and dtype takes, and the
direct K sum that its bf16 ``mma`` tiles compute against the twin's
difference form.

No CUDA kernel runs here: ``tests/test_torch_cuda.py`` holds the instance
against ``cheb2_twin`` on the card.
"""

import numpy as np
import pytest
import torch

from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops import cuda_cheb2
from portable_multigrid_tpu_torch.ops.cuda_cheb2 import (
    MMA_LAUNCHES,
    MMA_SMEM_TWO,
    MODES,
    Cheb2Kernel,
    Cheb2RKernel,
    cheb2_engine,
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


@pytest.mark.parametrize("core,dtype,rout,engine", [
    ("mxu", torch.float32, False, "mma"),
    ("banded", torch.float32, False, "fma"),
    ("banded", torch.float64, False, "fma"),
    ("mxu", torch.float64, False, "fma"),
    ("mxu", torch.float32, True, "fma"),
    ("banded", torch.float32, True, "fma"),
])
def test_engine_is_a_function_of_grade_and_dtype(core, dtype, rout, engine):
    """The production grade in float32 takes the tensor cores; the exact
    grade, float64 and cheb2lr keep the CUDA cores."""
    assert cheb2_engine(core, dtype, rout) == engine


@pytest.mark.parametrize("core,dtype", [("mxu", torch.float32),
                                        ("banded", torch.float32),
                                        ("banded", torch.float64)])
def test_kernels_take_the_engine_and_its_tile(core, dtype):
    """make_cheb2, make_cheb2_xext and make_cheb2_pencil build the pair on
    the engine of the operator's grade and dtype, with that engine's tile;
    the cheb2lr kernel keeps the CUDA-core tile."""
    p, r = 2, 3
    op = make_cuda_laplace(FESpace(HyperCubeMesh(3, r), p), dtype,
                           core=core)
    N = op.n * p
    itemsize = torch.empty((), dtype=dtype).element_size()
    engine = cheb2_engine(core, dtype)
    kern = make_cheb2(op)
    assert isinstance(kern, Cheb2Kernel) and kern.engine == engine
    want = (cheb2_mma_tile(p, N) if engine == "mma"
            else cheb2_tile(p, itemsize, N))
    assert kern.tile == want
    shard = make_cheb2_xext(op, N // 4, N // 4)
    pencil = make_cheb2_pencil(op, 0, N // 2, N // 2, N // 2)
    assert shard.engine == pencil.engine == engine
    if engine == "mma":
        assert shard.tile == cheb2_mma_tile(p, N, nx=N // 4)
        assert pencil.tile == cheb2_mma_tile(p, N, nx=N // 2, ny=N // 2)
    rk = make_cheb2(op, rout=True)
    assert isinstance(rk, Cheb2RKernel)
    assert rk.tile == cheb2_tile(p, itemsize, N, rout=True)


def test_mma_counter_counts_no_cpu_pass():
    """MMA_LAUNCHES is keyed as LAUNCHES; a CPU tensor runs the twin, and
    neither counter moves."""
    assert set(MMA_LAUNCHES) >= set(MODES)
    op = make_cuda_laplace(FESpace(HyperCubeMesh(3, 2), 2), torch.float32,
                           core="mxu")
    N = op.n * 2
    rng = np.random.default_rng(0)
    d, r, x = (torch.as_tensor(rng.standard_normal((N,) * 3),
                               dtype=torch.float32) for _ in range(3))
    before = dict(MMA_LAUNCHES), dict(cuda_cheb2.LAUNCHES)
    scal = (0.59, 1.26, 0.71, 1.52)
    got = make_cheb2(op).steps2(d, r, x, scal, "cheb2")
    want = cheb2_twin(op, d, r, x, scal, "cheb2")
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (dict(MMA_LAUNCHES), dict(cuda_cheb2.LAUNCHES)) == before


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
