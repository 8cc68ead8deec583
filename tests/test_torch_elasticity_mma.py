"""B.5's tensor-core instance (``csrc/elasticitymma.cu``) on the CPU: its
tile and shared-memory formula, the instance each core, dtype, degree and
shape builds, the direct K, G and H sums that its bf16 ``mma`` tiles
compute against the difference form, and its march (the x stage pushed
into a ring of 2p planes) against the twin.

No CUDA kernel runs here: ``tests/test_torch_cuda.py`` holds the instance
against ``elasticity_twin`` on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

from portable_multigrid_tpu_torch import _build
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops import cuda_elasticity
from portable_multigrid_tpu_torch.ops.cuda_elasticity import (
    MMA_THREADS_SM,
    CudaElasticitySlab,
    elasticity_grouped,
    elasticity_mma_smem_bytes,
    elasticity_mma_tile,
    elasticity_tile,
    elasticity_twin,
    make_cuda_elasticity,
)
from portable_multigrid_tpu_torch.ops.cuda_laplace import (
    MODES,
    SMEM_LIMIT,
    banded,
    round_bf16,
)

torch.set_num_threads(1)

MU, LAM = 0.7, 1.3
SM_SHARED = 228 * 1024  # an H100 SM's shared memory, 1 KB of it a block's


@pytest.mark.parametrize("p", range(1, 8))
def test_mma_tile_fits_shared_memory(p):
    """At every degree the tile launches: whole 8-row groups of two warps,
    within 232,448 bytes of shared memory a block and its blocks within an
    SM, at most 384 threads an SM; the chunk is one of ceil(N / k) for k
    chunks."""
    for N in (2 * p, 8 * p, 64 * p):
        lx, ty, nw = elasticity_mma_tile(p, N)
        assert ty in (8, 16, 24, 32) and nw == ty // 4
        smem = elasticity_mma_smem_bytes(p, ty)
        assert smem <= SMEM_LIMIT == 232448
        blocks = min(SM_SHARED // (smem + 1024), MMA_THREADS_SM // (32 * nw))
        assert blocks >= 1 and blocks * (smem + 1024) <= SM_SHARED
        assert blocks * 32 * nw <= MMA_THREADS_SM
        assert 1 <= lx <= N and lx == -(-N // -(-N // lx))
    # one more 8-row group: two warps' ring of 2p planes (three float4 a
    # thread) and 8 window rows of the three components in both buffers
    assert (elasticity_mma_smem_bytes(p, 16) - elasticity_mma_smem_bytes(p, 8)
            == 16 * 2 * p * 3 * 64 + 2 * 2 * 3 * 8 * 56)


def test_mma_tile_of_the_elasticity_cell():
    """Q3 r=6: 24 rows, 6 warps, two blocks an SM; the 192^3 level in five
    chunks of 39 planes (one wave of 240 blocks), the lower levels in
    short chunks."""
    assert elasticity_mma_tile(3, 192) == (39, 24, 6)
    smem = elasticity_mma_smem_bytes(3, 24)
    assert 2 * (smem + 1024) <= SM_SHARED < 3 * (smem + 1024)
    assert [elasticity_mma_tile(3, 3 * 2 ** r)[0]
            for r in range(5, 0, -1)] == [5, 2, 2, 2, 2]


class _Entries:
    """Stands in for the kernel library: an entry point is its name."""

    @staticmethod
    def fn(base, dtype_suffix=None):
        return base if dtype_suffix is None else f"{base}_{dtype_suffix}"


@pytest.mark.parametrize("core,dtype,p,slab,entry", [
    ("mxu", torch.float32, 3, False, "pmg_elasticitymma"),
    ("mxu", torch.float32, 1, False, "pmg_elasticitymma"),
    ("mxu", torch.float32, 7, False, "pmg_elasticitymma"),
    ("banded", torch.float32, 3, False, "pmg_elasticity_f32"),
    ("banded", torch.float64, 3, False, "pmg_elasticity_f64"),
    ("mxu", torch.float64, 3, False, None),
    ("mxu", torch.float32, 3, True, None),
    ("banded", torch.float32, 3, True, "pmg_elasticity_f32"),
])
def test_engine_is_a_function_of_core_dtype_degree_and_shape(
        monkeypatch, core, dtype, p, slab, entry):
    """The core picks the instance: the mxu core on the cube launches the
    tensor cores at every degree with their tile; the exact core, in
    float32 and float64, and the slab launch the CUDA cores with theirs.
    The mxu core in float64 and a slab at the mxu core raise ValueError."""
    from portable_multigrid_tpu_torch.parallel.elasticity import (
        sharded_cuda_elasticity,
    )

    monkeypatch.setattr(_build, "build", lambda: _Entries)
    sp = FESpace(HyperCubeMesh(3, 2), p)
    N = 4 * p
    itemsize = torch.empty((), dtype=dtype).element_size()
    if slab:
        op = sharded_cuda_elasticity(sp, [torch.device("cpu")] * 2, dtype,
                                     MU, LAM).local[0]
        assert isinstance(op, CudaElasticitySlab)
        if entry is None:
            with pytest.raises(ValueError, match="exact core"):
                dataclasses.replace(op, core=core)
            return
        assert op.tile == elasticity_tile(p, itemsize, N, nx=N // 2)
    elif entry is None:
        with pytest.raises(ValueError, match="float32"):
            make_cuda_elasticity(sp, dtype, MU, LAM, core=core)
        return
    else:
        op = make_cuda_elasticity(sp, dtype, MU, LAM, core=core)
        assert op.tile == (elasticity_mma_tile(p, N) if core == "mxu"
                           else elasticity_tile(p, itemsize, N))
    assert op.kernel_fn() == entry


@pytest.mark.parametrize("core,dtype", [("mxu", torch.float32),
                                        ("banded", torch.float32),
                                        ("banded", torch.float64)])
def test_operators_take_the_engine_and_its_tile(core, dtype):
    """make_cuda_elasticity builds the operator with the tile of its core's
    instance; the slab of the sharded solve has the CUDA-core instance's
    tile, and refuses the mxu core."""
    from portable_multigrid_tpu_torch.parallel.elasticity import (
        sharded_cuda_elasticity,
    )

    p, r = 3, 2
    sp = FESpace(HyperCubeMesh(3, r), p)
    op = make_cuda_elasticity(sp, dtype, MU, LAM, core=core)
    N = op.n * p
    itemsize = torch.empty((), dtype=dtype).element_size()
    assert op.tile == (elasticity_mma_tile(p, N) if core == "mxu"
                       else elasticity_tile(p, itemsize, N))
    if dtype == torch.float32 and core == "banded":
        slab = sharded_cuda_elasticity(sp, [torch.device("cpu")] * 2, dtype,
                                       MU, LAM).local[0]
        assert isinstance(slab, CudaElasticitySlab)
        assert slab.tile == elasticity_tile(p, itemsize, N, nx=N // 2)
        with pytest.raises(ValueError, match="exact core"):
            dataclasses.replace(slab, core="mxu")


def test_mma_counter_counts_no_cpu_pass():
    """On a CPU tensor the mxu operator runs the twin, and no LAUNCHES key
    moves."""
    assert set(cuda_elasticity.LAUNCHES) >= set(MODES)
    op = make_cuda_elasticity(FESpace(HyperCubeMesh(3, 2), 2), torch.float32,
                              MU, LAM, core="mxu")
    rng = np.random.default_rng(0)
    u, r, x = (torch.as_tensor(rng.standard_normal(op.trimmed_shape),
                               dtype=torch.float32) for _ in range(3))
    before = dict(cuda_elasticity.LAUNCHES)
    got = op.run("cheb", u, (r, x), (0.59, 1.26))
    want = elasticity_twin(op, "cheb", u, (r, x), (0.59, 1.26))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert dict(cuda_elasticity.LAUNCHES) == before


@pytest.mark.parametrize("p", range(1, 8))
def test_direct_sums_at_the_bf16_grade(p):
    """The tensor-core instance sums K, G and H directly: in float64 the
    direct and the difference form are one operator (the row sums are
    those of the bands); at the bf16 grade in float32 (bf16 bands, a bf16
    input, float sums) the direct sum lands within the bound that the
    on-card tests hold the kernel to (1e-2 of the max) of the difference
    form, and on most points far closer."""
    rng = np.random.default_rng(p)
    sp = FESpace(HyperCubeMesh(3, 2), p)
    N = 4 * p
    mask = np.ones(N)
    mask[0] = 0.0
    u = rng.standard_normal((N,) * 3) * np.einsum("i,j,k->ijk", mask, mask,
                                                  mask)
    op64 = make_cuda_elasticity(sp, torch.float64, MU, LAM)
    op = make_cuda_elasticity(sp, torch.float32, MU, LAM, core="mxu")
    u64 = torch.as_tensor(u)
    u32 = round_bf16(u64.to(torch.float32))
    for X in "kgh":
        for ax in range(3):
            band, rows = (getattr(op64, X + "band"), getattr(op64, X + "sum"))
            diff = banded(u64, band, ax, rows)
            direct = banded(u64, band, ax)
            scale = float(diff.abs().max())
            assert float((direct - diff).abs().max()) <= 1e-12 * scale
            band, rows = (getattr(op, X + "band"), getattr(op, X + "sum"))
            diff = banded(u32, band, ax, rows)
            direct = banded(u32, band, ax)
            err = (direct - diff).abs() / float(diff.abs().max())
            assert float(err.max()) <= 1e-2
            assert float((err > 2.0 ** -18).double().mean()) <= 5e-2


def mma_march(op, u, lx):
    """B.5's tensor-core march in plain torch, float64: x chunks of ``lx``
    output planes marched from p lead-in planes before to p after; per
    input plane the window rounded to bf16, the z products (K, M, G, H) of
    each component rounded, the y-z products summed into the 12 groups
    (output c, x matrix) and rounded; then the push: the groups times
    column x_in of each x matrix added to the outputs of planes x_in - p ..
    x_in + p in a ring of 2p slots, slot (x - x0) % 2p, written by plane x
    - p and read, completed, by plane x + p.  Every sum direct."""
    p = op.degree
    S, N = 2 * p, op.n * p
    bands = {X: getattr(op, X + "band").double() for X in "kmgh"}

    def W(X, t, ax):
        return banded(t, bands[X], ax)

    mu, lam = op.mu, op.lam
    al = 2 * mu + lam
    out = torch.zeros_like(u)
    for x0 in range(0, N, lx):
        xend = min(x0 + lx, N)
        ring = [None] * S
        for xin in range(x0 - p, xend + p):
            plane = round_bf16(u[:, xin] if 0 <= xin < N
                               else torch.zeros_like(u[:, 0]))
            g = {}
            for a in range(3):
                z = {X: round_bf16(W(X, plane[a], 1)) for X in "kmgh"}

                def y(name):
                    return W(name[0], z[name[1]], 0)

                terms = {
                    0: [("0k", al, "mm"), ("0m", mu, "km"), ("0m", mu, "mk"),
                        ("1g", mu, "hm"), ("1h", lam, "gm"), ("2g", mu, "mh"),
                        ("2h", lam, "mg")],
                    1: [("1k", mu, "mm"), ("1m", al, "km"), ("1m", mu, "mk"),
                        ("0h", mu, "gm"), ("0g", lam, "hm"), ("2m", mu, "gh"),
                        ("2m", lam, "hg")],
                    2: [("2k", mu, "mm"), ("2m", mu, "km"), ("2m", al, "mk"),
                        ("0h", mu, "mg"), ("0g", lam, "mh"), ("1m", mu, "hg"),
                        ("1m", lam, "gh")],
                }[a]
                for key, wt, name in terms:
                    g[key] = g.get(key, 0.0) + wt * y(name)
            g = {k: round_bf16(v) for k, v in g.items()}
            for o in range(2 * p + 1):
                x = xin - p + o
                if x < x0 or x >= xend:
                    continue
                v = [sum(bands[X][2 * p - o, x] * g[f"{c}{X}"]
                         for X in "kmgh") for c in range(3)]
                s = (x - x0) % S
                if o == 2 * p:
                    ring[s] = v
                elif o == 0:
                    out[:, x] = torch.stack([ring[s][c] + v[c]
                                             for c in range(3)])
                else:
                    ring[s] = [ring[s][c] + v[c] for c in range(3)]
    return out


@pytest.mark.parametrize("p,r,lx", [(1, 2, 3), (2, 2, 5), (3, 1, 4),
                                    (3, 2, 39), (4, 1, 3), (5, 1, 2),
                                    (6, 1, 5), (7, 1, 2)])
def test_march_matches_twin(p, r, lx):
    """The march with its pushed x stage and direct sums gives the twin's
    bf16-grade operator (elasticity_grouped) at float64 sums, in chunks
    that divide N and that leave a short last chunk."""
    op = make_cuda_elasticity(FESpace(HyperCubeMesh(3, r), p), torch.float32,
                              MU, LAM, core="mxu")
    u = torch.as_tensor(np.random.default_rng(20 + p).standard_normal(
        op.trimmed_shape))
    K, M, G = (t.double() for t in (op.Kt, op.Mt, op.Gt))
    want = elasticity_grouped(u, K, M, G, MU, LAM, bf16_grade=True)
    got = mma_march(op, u, min(lx, op.n * p))
    assert float((want - got).abs().max()) <= 1e-12 * float(want.abs().max())
