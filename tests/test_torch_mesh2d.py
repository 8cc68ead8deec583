"""The 2D-pencil sharded solve's plain path (``portable_multigrid_tpu_torch/
parallel/mesh2d.py``) against the JAX package's ``parallel/mesh2d.py`` on
the CPU: the partition helpers exactly, the ordered 2D halo exchange at
the points four pencils share, the pencil apply and dot, whole solves (CG
counts equal, L2 to 1e-10), ``Gather2DTransfer`` and the constructor's
errors.  The port runs sx sy pencils on ``[torch.device("cpu")] * (sx
sy)``; the JAX side runs on the conftest's 8 virtual CPU devices.  Inputs
come from numpy seeds."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.ops.transfer import (
    make_h_transfer as jmake_h_transfer,
)
from portable_multigrid_tpu.parallel import mesh2d as jmesh2d
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.ops.laplace import make_laplace
from portable_multigrid_tpu_torch.ops.transfer import make_h_transfer
from portable_multigrid_tpu_torch.parallel import mesh2d, sharding

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _pmg_defaults():
    """Every PMG_* setting of both packages at its default."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("PMG_")]:
            mp.delenv(key)
        yield


def _pencils(field, mesh):
    """A pencil-sharded field's parts as [sx][sy] NumPy arrays."""
    sx, sy = mesh
    parts = [t.numpy() for t in field.parts]
    return [parts[i * sy: (i + 1) * sy] for i in range(sx)]


@pytest.mark.parametrize("mesh", [(2, 2), (4, 2), (2, 4)])
def test_partition_helpers_match_jax(mesh):
    """partition_2d and unpartition_2d equal the JAX functions, in 3D and
    2D, and invert each other."""
    sx, sy = mesh
    n, p = 8, 2
    rng = np.random.default_rng(sx + 3 * sy)
    for shape in ((17, 17, 17), (17, 17)):
        arr = rng.standard_normal(shape)
        got = mesh2d.partition_2d(arr, n, p, sx, sy)
        np.testing.assert_array_equal(got, jmesh2d.partition_2d(arr, n, p,
                                                                sx, sy))
        np.testing.assert_array_equal(
            mesh2d.unpartition_2d(got, n, p, sx, sy),
            jmesh2d.unpartition_2d(got, n, p, sx, sy))
        np.testing.assert_array_equal(
            mesh2d.unpartition_2d(got, n, p, sx, sy), arr)


@pytest.mark.parametrize("mesh", [(2, 2), (4, 2), (2, 4)])
def test_halo_sum_2d_completes_the_corners(mesh):
    """Each pencil's own partial values, every value distinct: after
    halo_sum_2d every pencil holds the global sum of the contributions at
    its points, the lines that four pencils share included."""
    sx, sy = mesh
    n, p, Z = 8, 2, 3
    bx, by = sharding.slab_bounds(n, p, sx), sharding.slab_bounds(n, p, sy)
    rng = np.random.default_rng(7)
    parts, total = [], np.zeros((n * p + 1, n * p + 1, Z))
    for i in range(sx):
        for j in range(sy):
            (x0, x1), (y0, y1) = bx[i], by[j]
            a = rng.standard_normal((x1 - x0, y1 - y0, Z))
            total[x0:x1, y0:y1] += a
            parts.append(torch.from_numpy(a))
    got = sharding.halo_sum_2d(parts, sx, sy)
    for s, t in enumerate(got):
        (x0, x1), (y0, y1) = bx[s // sy], by[s % sy]
        np.testing.assert_allclose(t.numpy(), total[x0:x1, y0:y1], rtol=0,
                                   atol=1e-14)


@pytest.mark.parametrize("dim,p,mesh", [(3, 2, (2, 2)), (3, 2, (4, 2)),
                                        (2, 3, (2, 2))])
@pytest.mark.parametrize("variant", ["kron", "sumfac"])
def test_pencil_apply_matches_single_device(variant, dim, p, mesh):
    """The plain pencil operator (local apply, halo_sum_2d, the mask
    combine) equals the single-device apply within 1e-12 in float64, at
    r = 3; the duplicated planes agree."""
    sx, sy = mesh
    sp = FESpace(HyperCubeMesh(dim, 3), p)
    n = sp.mesh.cells_per_axis
    u = np.random.default_rng(p).standard_normal(sp.grid_shape)
    want = make_laplace(sp, torch.float64, "kron").apply(
        torch.from_numpy(u)).numpy()
    op = mesh2d._build_pencil_operator(sp, mesh, [CPU] * (sx * sy),
                                       torch.float64, variant)
    got = op.apply(mesh2d.shard_2d(u, n, p, mesh, [CPU] * (sx * sy),
                                   torch.float64))
    scale = np.abs(want).max()
    st = mesh2d.partition_2d(want, n, p, sx, sy)
    for s, t in enumerate(got.parts):
        np.testing.assert_allclose(t.numpy(), st[s // sy, s % sy], rtol=0,
                                   atol=1e-12 * scale)


def test_pencil_dot_matches_global():
    """The pencil-weighted dot (make_sharded_dot with [Nx, Ny] weights per
    shard) equals the global inner product."""
    sx, sy, n, p = 4, 2, 8, 2
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal((17, 17, 17)) for _ in range(2))
    w = mesh2d.dot_weights_2d(n, p, sx, sy)
    dot = sharding.make_sharded_dot(
        [torch.from_numpy(w[s // sy, s % sy]) for s in range(sx * sy)], 3)
    fa, fb = (mesh2d.shard_2d(v, n, p, (sx, sy), [CPU] * 8, torch.float64)
              for v in (a, b))
    assert float(dot(fa, fb)) == pytest.approx(float(np.vdot(a, b)),
                                               rel=1e-13)


@pytest.mark.parametrize("args", [(3, 2, 3, (4, 2)), (2, 3, 3, (2, 2))])
def test_plain_solve_matches_jax(args):
    """Sharded2DGeometricPoisson on kron, float64, rtol 1e-12: JAX's CG
    count, L2 norm to 1e-10 and x to 1e-10 max|x| (3D Q2 r=3 on (4, 2),
    the JAX package's dryrun_multichip case, and 2D Q3 r=3 on (2, 2), as
    tests/test_sharding.py runs them); sumfac gives the same."""
    dim, p, r, mesh = args
    jx, jst = jmesh2d.Sharded2DGeometricPoisson(
        *args, devices=jax.devices()[:8]).solve()
    x, st = mesh2d.Sharded2DGeometricPoisson(*args,
                                             devices=[CPU] * 8).solve()
    assert st.converged and st.iterations == jst.iterations
    assert st.mesh_shape == jst.mesh_shape and st.n_dofs == jst.n_dofs
    assert st.solution_l2_norm == pytest.approx(jst.solution_l2_norm,
                                                rel=1e-10)
    jx = np.asarray(jx)
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-10 * np.abs(jx).max())
    if dim == 3:
        _, st2 = mesh2d.Sharded2DGeometricPoisson(
            3, 2, 3, (2, 2), devices=[CPU] * 4, variant="sumfac").solve()
        assert st2.iterations == jst.iterations
        assert st2.solution_l2_norm == pytest.approx(jst.solution_l2_norm,
                                                     rel=1e-10)


def test_gather_transfer_matches_jax():
    """Gather2DTransfer (the replicated level below the first pencil
    level) against JAX's under shard_map, Q2 r=0 -> r=1 on (2, 2):
    restrict of a consistent fine pencil field, prolongate of a
    replicated coarse field, float64."""
    sx, sy, p = 2, 2, 2
    jc, jf = JSpace(JMesh(3, 0), p), JSpace(JMesh(3, 1), p)
    coarse, fine = FESpace(HyperCubeMesh(3, 0), p), FESpace(
        HyperCubeMesh(3, 1), p)
    rng = np.random.default_rng(11)
    f = rng.standard_normal(fine.grid_shape)
    c = rng.standard_normal(coarse.grid_shape)
    jtr = jmesh2d.Gather2DTransfer(
        sx=sx, sy=sy, stride_x=p, nx_pts=p + 1, stride_y=p, ny_pts=p + 1,
        local=jmesh2d._tile_tree2(jmake_h_transfer(jc, jf, jnp.float64), sx,
                                  sy))
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(sx, sy),
                (jmesh2d.AX, jmesh2d.AY))

    def g(tr_st, f_st, c_st):
        tr = jax.tree_util.tree_map(lambda a: a[0, 0], tr_st)
        return (tr.restrict(f_st[0, 0])[None, None],
                tr.prolongate(c_st[0, 0])[None, None])

    spec = P(jmesh2d.AX, jmesh2d.AY)
    want_r, want_p = (np.asarray(o) for o in jax.jit(jax.shard_map(
        g, mesh=mesh, in_specs=(spec,) * 3, out_specs=(spec,) * 2,
        check_vma=False))(
            jtr, jnp.asarray(jmesh2d.partition_2d(f, 2, p, sx, sy)),
            jnp.asarray(np.broadcast_to(c, (sx, sy) + c.shape))))
    devices = [CPU] * 4
    tr = mesh2d.Gather2DTransfer(
        local=sharding.per_device(
            lambda dev: make_h_transfer(coarse, fine, torch.float64, dev),
            devices),
        mesh=(sx, sy), stride=(p, p), n_points=(p + 1, p + 1))
    got_r = tr.restrict(mesh2d.shard_2d(f, 2, p, (sx, sy), devices,
                                        torch.float64))
    got_p = tr.prolongate(sharding.ShardedField(
        [torch.from_numpy(c)] * 4))
    for s in range(4):
        np.testing.assert_allclose(got_r.parts[s].numpy(),
                                   want_r[s // sy, s % sy], rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(got_p.parts[s].numpy(),
                                   want_p[s // sy, s % sy], rtol=0,
                                   atol=1e-12)


@pytest.mark.parametrize("args,kw", [
    ((3, 2, 3, (4, 4)), {}),  # too few devices
    ((3, 2, 3, (3, 2)), {}),  # 4 cells at r = 2 do not split in 3
    ((1, 2, 3, (2, 2)), {}),  # dim < 2
    ((3, 2, 1, (4, 2)), {}),  # fewer refinements than log2(4)
    ((3, 2, 3, (2, 2)), {"variant": "foo"}),
])
def test_errors_match_jax(args, kw):
    """Each constructor error of the JAX class is a ValueError of the
    port's, with 8 devices on each side."""
    with pytest.raises(ValueError):
        jmesh2d.Sharded2DGeometricPoisson(*args, devices=jax.devices()[:8],
                                          **kw)
    with pytest.raises(ValueError):
        mesh2d.Sharded2DGeometricPoisson(*args, devices=[CPU] * 8, **kw)


def test_defaults_to_the_cards():
    """devices=None means every CUDA card: without one the constructor
    raises and names the CPU list."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh2d.Sharded2DGeometricPoisson(3, 2, 3, (2, 2))
