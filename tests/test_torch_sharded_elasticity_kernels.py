"""The sharded elasticity kernel path's plain twins against the JAX
package on the CPU: B.5's slab instance (``CudaElasticitySlab``, ``apply``
on x-full input) against JAX's ``_build_stacked_pallas_elasticity`` slab
kernel run in interpret mode (``loc._run("apply", ...)``), on the same
inputs (numpy seeds), on the first, an interior and the last shard; and
``ShardedCudaElasticity.apply`` (the slab, the 21-chain thin completion,
the three-component halo sum, the mask combine) against JAX's
``ShardedPallasElasticity`` under ``shard_map`` and against the port's
single-device ``kron`` apply.  Tolerances: 1e-12 of max |want| in
float64 (roundoff of sums over a few hundred terms); 2e-5 in float32, the
JAX package's own bound for the sharded kernel apply (``EXACT`` of
``tests/test_torch_sharding_kernels.py``)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.parallel import elasticity as jelasticity
from portable_multigrid_tpu.parallel import poisson as jpoisson
from portable_multigrid_tpu_torch import _build
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.cuda_elasticity import (
    CudaElasticitySlab,
    make_cuda_elasticity,
)
from portable_multigrid_tpu_torch.ops.cuda_laplace import MODES, row_sums
from portable_multigrid_tpu_torch.ops.elasticity import make_elasticity
from portable_multigrid_tpu_torch.parallel import sharding
from portable_multigrid_tpu_torch.parallel.elasticity import (
    _build_stacked_cuda_elasticity,
    _partial_assembled_gradient,
    shard_vector,
    sharded_cuda_elasticity,
)
from portable_multigrid_tpu_torch.parallel.poisson import (
    _partial_assembled_1d,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
MU, LAM = 0.7, 1.3
TOL = {torch.float64: 1e-12, torch.float32: 2e-5}
DTYPES = {torch.float64: jnp.float64, torch.float32: jnp.float32}


@pytest.fixture(scope="module", autouse=True)
def _pmg_defaults():
    """Every PMG_* setting of both packages at its default."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("PMG_")]:
            mp.delenv(key)
        yield


def _masked_slab(rng, s, L, N):
    """A random x-full slab input [3, L + 1, N, N] of shard s, zero on the
    constrained planes (global plane 0 of each axis, the global last x
    plane)."""
    u = rng.standard_normal((3, L + 1, N, N))
    gx = s * L + np.arange(L + 1)
    u[:, (gx == 0) | (gx >= N)] = 0.0
    u[:, :, 0], u[:, :, :, 0] = 0.0, 0.0
    return u


@pytest.mark.parametrize("s", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_slab_twin_matches_jax_interpret(dtype, s):
    """B.5's slab twin against JAX's interpret-mode slab kernel
    (``xmask="vector"``, zpad 0: its input the full y-z grid, here the
    trimmed one with a zero row and column appended), Q4 r=3 S=4, mu 0.7,
    lam 1.3, on the first, an interior and the last shard."""
    p, r, S = 4, 3, 4
    jop = jelasticity._build_stacked_pallas_elasticity(
        JSpace(JMesh(3, r), p), S, DTYPES[dtype], MU, LAM, interpret=True,
        zpad=0)
    assert jop is not None
    op = sharded_cuda_elasticity(FESpace(HyperCubeMesh(3, r), p), [CPU] * S,
                                 dtype, MU, LAM)
    N = 2 ** r * p
    L = N // S
    u = _masked_slab(np.random.default_rng(s), s, L, N)
    loc = jax.tree_util.tree_map(lambda a: a[s], jop).local
    want = np.stack([np.asarray(w, np.float64) for w in loc._run(
        "apply", jnp.asarray(np.pad(u, ((0, 0), (0, 0), (0, 1), (0, 1))),
                             DTYPES[dtype]))])
    (got,) = op.local[s].run("apply", torch.as_tensor(u, dtype=dtype))
    assert got.shape == want.shape == (3, L, N, N)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                               atol=TOL[dtype] * np.abs(want).max())


def test_sharded_apply_matches_jax_and_kron():
    """ShardedCudaElasticity.apply in float64 against JAX's
    ShardedPallasElasticity under shard_map (interpret mode, zpad 0) and
    against the port's single-device kron apply, Q4 r=2, S = 2, mu 0.7,
    lam 1.3 (the setup of the JAX package's
    test_sharded_pallas_elasticity_apply_matches_kron); the duplicated
    planes equal across the shards bit for bit."""
    p, r, S = 4, 2, 2
    jsp = JSpace(JMesh(3, r), p)
    sp = FESpace(HyperCubeMesh(3, r), p)
    n = sp.mesh.cells_per_axis
    sop = jelasticity._build_stacked_pallas_elasticity(
        jsp, S, jnp.float64, MU, LAM, interpret=True, zpad=0)
    u = np.random.default_rng(7).standard_normal((3,) + sp.grid_shape)
    u_st = np.stack([np.stack([sharding.partition_axis0(u[c], n, p, S)[s]
                               for c in range(3)]) for s in range(S)])
    mesh = Mesh(np.array(jax.devices()[:S]), (jpoisson.AXIS,))
    want = np.asarray(jax.jit(jax.shard_map(
        lambda o, v: jpoisson._unstack(o).apply(v[0])[None], mesh=mesh,
        in_specs=(P(jpoisson.AXIS), P(jpoisson.AXIS)),
        out_specs=P(jpoisson.AXIS), check_vma=False))(sop, jnp.asarray(u_st)))
    op = sharded_cuda_elasticity(sp, [CPU] * S, torch.float64, MU, LAM)
    got = op.apply(shard_vector(u, n, p, [CPU] * S, torch.float64))
    scale = np.abs(want).max()
    for s in range(S):
        np.testing.assert_allclose(got.parts[s].numpy(), want[s], rtol=0,
                                   atol=1e-12 * scale)
    kron = make_elasticity(sp, torch.float64, MU, LAM).apply(
        torch.as_tensor(u)).numpy()
    for c in range(3):
        parts = sharding.partition_axis0(kron[c], n, p, S)
        for s in range(S):
            np.testing.assert_allclose(got.parts[s][c].numpy(), parts[s],
                                       rtol=0, atol=1e-12 * scale)
    for s in range(S - 1):
        assert torch.equal(got.parts[s][:, -1], got.parts[s + 1][:, 0])


@pytest.mark.parametrize("p,r,S", [(3, 3, 4), (2, 2, 2), (5, 2, 4)])
def test_duplicated_planes_equal(p, r, S):
    """After the halo sum a shared plane holds the same values on both of
    its shards, bit for bit (a + b on one, b + a on the other), float32,
    on every pair of neighbours."""
    sp = FESpace(HyperCubeMesh(3, r), p)
    n = sp.mesh.cells_per_axis
    u = np.random.default_rng(p).standard_normal((3,) + sp.grid_shape)
    op = sharded_cuda_elasticity(sp, [CPU] * S, torch.float32, MU, LAM)
    got = op.apply(shard_vector(u, n, p, [CPU] * S, torch.float32))
    for s in range(S - 1):
        assert torch.equal(got.parts[s][:, -1], got.parts[s + 1][:, 0])


def test_x_row_sums_from_partial_matrices():
    """The slab's x row sums of K, G and H equal the direct float64 row
    sums of the masked partial matrices at the first and the last shard,
    and so do the thin rows' sums.  The partial G's row 0 sums to -1
    where it is unmasked, which the Laplace rule (row_sums: a free row
    sums to zero) would miss."""
    p, r, S = 3, 3, 4
    sp = FESpace(HyperCubeMesh(3, r), p)
    n, L = 8, 8 // S * p
    Kp, _ = _partial_assembled_1d(sp, n // S)
    Gp = _partial_assembled_gradient(sp, n // S)
    op = sharded_cuda_elasticity(sp, [CPU] * S, torch.float64, MU, LAM)
    m1 = sp.free_mask_1d()
    for s in (0, S - 1):
        mx = sharding.partition_axis0(m1, n, p, S)[s]
        slab = op.local[s]
        for W, got, thin in ((Kp, slab.xksum, op.thin_ks),
                             (Gp, slab.xgsum, op.thin_gs),
                             (Gp.T, slab.xhsum, op.thin_hs)):
            direct = (mx[:, None] * W * mx[None, :]).sum(axis=1)
            np.testing.assert_allclose(got.numpy(), direct[:L], rtol=0,
                                       atol=1e-14)
            # the thin row: row L over its columns, the x mask on them
            assert abs(float(thin[s]) - (W[L] * mx).sum()) <= 1e-14
    # the last shard: row 0 of G is a free row of the slab's first cell
    assert float(op.local[S - 1].xgsum[0]) == pytest.approx(-1.0, abs=1e-14)
    assert abs(row_sums(Gp, mx)[0]) < 1e-12
    assert float(op.local[0].xgsum[0]) == 0.0  # masked: the Dirichlet face


def test_eligibility():
    """The port's rule: a 3D float32 level whose cells split evenly runs
    B.5's slab; 2D, float64 and an uneven split do not (and the packing
    refuses 2D and an uneven split at any dtype)."""
    sp = FESpace(HyperCubeMesh(3, 2), 3)
    op = _build_stacked_cuda_elasticity(sp, [CPU] * 4, torch.float32, MU,
                                        LAM)
    assert isinstance(op.local[0], CudaElasticitySlab)
    assert op.local[0].trimmed_shape == (3, 3, 12, 12)
    assert op.local[0].input_shape == (3, 4, 12, 12)
    assert _build_stacked_cuda_elasticity(sp, [CPU] * 4, torch.float64, MU,
                                          LAM) is None
    assert _build_stacked_cuda_elasticity(sp, [CPU] * 8, torch.float32, MU,
                                          LAM) is None
    sp2 = FESpace(HyperCubeMesh(2, 2), 3)
    assert _build_stacked_cuda_elasticity(sp2, [CPU] * 2, torch.float32, MU,
                                          LAM) is None
    for space, S in ((sp2, 2), (sp, 8)):
        with pytest.raises(ValueError):
            sharded_cuda_elasticity(space, [CPU] * S, torch.float64, MU, LAM)


def test_slab_refuses_every_mode_but_apply():
    """The slab runs apply alone, on its x-full input, at the exact core."""
    sp = FESpace(HyperCubeMesh(3, 2), 2)
    slab = sharded_cuda_elasticity(sp, [CPU] * 2, torch.float32, MU,
                                   LAM).local[1]
    u = torch.zeros(slab.input_shape)
    t = torch.zeros(slab.trimmed_shape)
    assert slab.run("apply", u)[0].shape == slab.trimmed_shape
    for mode in MODES[1:] + ("chebf", "residual3f"):
        with pytest.raises(ValueError):
            slab.run(mode, u, (t, t), (0.5, 0.5))
    with pytest.raises(ValueError):
        slab.run("apply", u, (t,))
    with pytest.raises(ValueError):
        slab.run("apply", t)  # not x-full
    with pytest.raises(ValueError):
        slab.run("apply", u.double())


def test_kernel_arguments_match_the_entry_point():
    """The arguments the wrapper hands to pmg_elasticity_f32/_f64 (u, two
    inputs, three outputs, the operator's arrays, its scalars and c0, c1,
    its sizes, the degree, the mode, the tile, the flags, the stream) are
    as many as the entry point's signature, for the cube and the slab; the
    cube hands its y-z factors as its x ones, NX = NXI = N."""
    sp = FESpace(HyperCubeMesh(3, 2), 2)
    cube = make_cuda_elasticity(sp, torch.float32, MU, LAM)
    slab = sharded_cuda_elasticity(sp, [CPU] * 2, torch.float32, MU,
                                   LAM).local[0]
    for op in (cube, slab):
        n = (6 + len(op.kernel_state()) + len(op.kernel_scalars()) + 2
             + len(op.kernel_sizes()) + 2 + len(op.tile) + 2)
        assert n == len(_build._SIGNATURES["pmg_elasticity"])
    state = cube.kernel_state()
    assert all(a is b for a, b in zip(state[:9], state[9:]))
    assert cube.kernel_sizes() == (8, 8, 8)
    assert slab.kernel_sizes() == (8, 4, 5)
