"""The slab-sharded solve's plain path (``portable_multigrid_tpu_torch/
parallel/``) against the JAX package's ``parallel/`` on the CPU: the
partition helpers exactly, the sharded apply and dot, whole solves (CG
counts equal, L2 to 1e-10), ``cg(..., dot=)``, the driver's ``--sharded``
and the no-JAX rule.  The port runs S shards on ``[torch.device("cpu")] *
S``; the JAX side runs on the conftest's 8 virtual CPU devices.  Inputs
come from numpy seeds."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.parallel import poisson as jpoisson
from portable_multigrid_tpu.parallel import sharding as jsharding
from portable_multigrid_tpu_torch import GeometricMultigridPoisson
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.models.poisson import (
    PolynomialMultigridPoisson,
)
from portable_multigrid_tpu_torch.parallel import sharding
from portable_multigrid_tpu_torch.parallel.poisson import (
    ShardedGeometricPoisson,
    ShardedPolynomialPoisson,
    _build_stacked_operator,
    _partial_assembled_1d,
)
from portable_multigrid_tpu_torch.solvers.cg import cg

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _pmg_defaults():
    """Every PMG_* setting of both packages at its default."""
    with pytest.MonkeyPatch.context() as mp:
        for key in [k for k in os.environ if k.startswith("PMG_")]:
            mp.delenv(key)
        yield


def _golden(p, r):
    with open(ROOT / "tests" / "golden_convergence.json") as fh:
        rows = json.load(fh)["geometric_3d"]
    return next(row for row in rows
                if (row["degree"], row["refinements"]) == (p, r))


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("p", [1, 2, 3, 4])
def test_partition_helpers_equal_jax(p, S):
    n = 8
    N = n * p + 1
    a = np.random.default_rng(p + S).standard_normal((N, 3))
    assert sharding.slab_bounds(n, p, S) == jsharding.slab_bounds(n, p, S)
    want = jsharding.partition_axis0(a, n, p, S)
    got = sharding.partition_axis0(a, n, p, S)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        sharding.partition_axis0(torch.from_numpy(a), n, p, S).numpy(), want)
    np.testing.assert_array_equal(sharding.unpartition_axis0(got, n, p, S),
                                  jsharding.unpartition_axis0(want, n, p, S))
    np.testing.assert_array_equal(sharding.unpartition_axis0(got, n, p, S), a)
    np.testing.assert_array_equal(
        sharding.unpartition_axis0(list(torch.from_numpy(got)), n, p,
                                   S).numpy(), a)
    np.testing.assert_array_equal(sharding.dot_weights_axis0(n, p, S),
                                  jsharding.dot_weights_axis0(n, p, S))


def test_partition_rejects_uneven_slabs():
    with pytest.raises(ValueError, match="divisible"):
        sharding.slab_bounds(6, 2, 4)


def _jax_stacked_apply(sp, S, u, variant):
    op_st = jpoisson._build_stacked_operator(sp, S, jnp.float64, variant)
    n, p = sp.mesh.cells_per_axis, sp.degree
    mesh = Mesh(np.array(jax.devices()[:S]), (jpoisson.AXIS,))

    def f(op_stacked, u_stacked):
        sop = jsharding.ShardedLaplaceOperator(
            axis_name=jpoisson.AXIS, n_shards=S,
            local=jpoisson._unstack(op_stacked))
        return sop.apply(u_stacked[0])[None]

    return np.asarray(jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(P(jpoisson.AXIS), P(jpoisson.AXIS)),
        out_specs=P(jpoisson.AXIS), check_vma=False))(
            op_st, jnp.asarray(jsharding.partition_axis0(u, n, p, S))))


@pytest.mark.parametrize("variant", ["sumfac", "kron"])
@pytest.mark.parametrize("S", [2, 4, 8])
def test_sharded_apply_matches_jax(S, variant):
    """The plain sharded apply (local operator, halo_sum, mask combine),
    float64, Q2 r=3: within 1e-12 max|.| of the JAX package's stacked
    output on every shard; duplicated planes equal on both owners."""
    p, r = 2, 3
    u = np.random.default_rng(S).standard_normal((2 ** r * p + 1,) * 3)
    want = _jax_stacked_apply(JSpace(JMesh(3, r), p), S, u, variant)
    op = _build_stacked_operator(FESpace(HyperCubeMesh(3, r), p), [CPU] * S,
                                 torch.float64, variant)
    got = op.apply(sharding.shard(u, 2 ** r, p, [CPU] * S, torch.float64))
    scale = np.abs(want).max()
    for s in range(S):
        np.testing.assert_allclose(got.parts[s].numpy(), want[s],
                                   rtol=0, atol=1e-12 * scale)
    for s in range(S - 1):
        np.testing.assert_array_equal(got.parts[s][-1], got.parts[s + 1][0])


@pytest.mark.parametrize("S", [2, 8])
def test_sharded_dot_matches_global(S):
    p, n = 3, 8
    rng = np.random.default_rng(1)
    a, b = rng.standard_normal((2, n * p + 1, n * p + 1))
    w = [torch.from_numpy(v) for v in sharding.dot_weights_axis0(n, p, S)]
    dot = sharding.make_sharded_dot(w, 2)
    fa, fb = (sharding.shard(v, n, p, [CPU] * S, torch.float64)
              for v in (a, b))
    assert float(dot(fa, fb)) == pytest.approx(np.vdot(a, b), rel=1e-13)


def test_halo_sum_adds_neighbour_planes():
    parts = [torch.full((3, 2), float(s + 1)) for s in range(3)]
    out = sharding.halo_sum([t.clone() for t in parts])
    assert out[0][-1].tolist() == [3.0, 3.0] and out[0][0].tolist() == [1, 1]
    assert out[1][0].tolist() == [3.0, 3.0] and out[1][-1].tolist() == [5, 5]
    assert out[2][0].tolist() == [5.0, 5.0] and out[2][-1].tolist() == [3, 3]
    # a vector field's sharded axis is 1
    vec = [torch.full((2, 3, 2), float(s + 1)) for s in range(2)]
    out = sharding.halo_sum(vec, axis=1)
    assert out[0][:, -1].eq(3).all() and out[0][:, 0].eq(1).all()
    assert out[1][:, 0].eq(3).all() and out[1][:, -1].eq(2).all()


def test_sharded_field_arithmetic():
    f = sharding.ShardedField([torch.ones(2), torch.full((3,), 2.0)])
    g = torch.zeros_like(f)
    assert isinstance(g, sharding.ShardedField) and g.numel() == 5
    h = torch.tensor(3.0) * f - f / 2 + f * f
    assert h.parts[0].tolist() == [3.5, 3.5]
    assert h.parts[1].tolist() == [9.0, 9.0, 9.0]
    c = f.clone()
    assert c.parts[0] is not f.parts[0] and c.dtype == torch.float32
    # shards holding one tensor share each result
    one = torch.ones(2)
    rep = sharding.ShardedField([one, one]) * 2.0
    assert rep.parts[0] is rep.parts[1]


def test_cg_dot_default_unchanged():
    """``cg(..., dot=)``: the default is the plain dot, and the sharded dot
    on one shard reproduces the plain solve."""
    sp = FESpace(HyperCubeMesh(3, 2), 2)
    model = GeometricMultigridPoisson(3, 2, 2, torch.float64, "kron",
                                      device="cpu")
    A = model.fine_operator.apply
    b = model.rhs()
    mg = model.preconditioner()
    plain = cg(A, b, mg.apply, rtol=1e-12)
    explicit = cg(A, b, mg.apply, rtol=1e-12,
                  dot=lambda u, v: torch.dot(u.reshape(-1), v.reshape(-1)))
    assert plain.iterations == explicit.iterations
    assert torch.equal(plain.x, explicit.x)
    one = ShardedGeometricPoisson(3, 2, 2, devices=[CPU], variant="kron")
    x, st = one.solve()
    assert st.iterations == plain.iterations == _golden(2, 2)["iterations"]
    np.testing.assert_allclose(x, plain.x.numpy(), rtol=0,
                               atol=1e-13 * float(plain.x.abs().max()))
    assert sp.n_dofs == st.n_dofs


def test_sharded_solve_matches_jax_and_golden():
    """Q2 r=3, S = 4, float64 on the plain path: the JAX package's sharded
    CG count, the golden row, L2 to 1e-10, x within 1e-10 of JAX's."""
    jx, jst = jpoisson.ShardedGeometricPoisson(
        3, 2, 3, devices=jax.devices()[:4]).solve()
    x, st = ShardedGeometricPoisson(3, 2, 3, devices=[CPU] * 4).solve()
    row = _golden(2, 3)
    assert st.converged and st.iterations == jst.iterations
    assert st.iterations == row["iterations"]
    assert st.dofs_per_level == jst.dofs_per_level
    assert st.solution_l2_norm == pytest.approx(row["l2_norm"], rel=1e-10)
    jx = np.asarray(jx)
    np.testing.assert_allclose(x, jx, rtol=0, atol=1e-10 * np.abs(jx).max())


@pytest.mark.parametrize("variant,setup", [("kron", False), ("kron", True),
                                           ("sumfac", True)])
def test_sharded_variants_and_setup_match_single_device(variant, setup):
    """kron and sharded_setup (eig-CG on the sharded operator) give the
    single-device count and x, float64 Q2 r=3 S = 4."""
    x, st = ShardedGeometricPoisson(3, 2, 3, devices=[CPU] * 4,
                                    variant=variant,
                                    sharded_setup=setup).solve()
    x1, st1 = GeometricMultigridPoisson(3, 2, 3, torch.float64, variant,
                                        device="cpu").solve()
    assert st.converged and st.iterations == st1.iterations
    np.testing.assert_allclose(x, x1.numpy(), rtol=0,
                               atol=1e-10 * float(x1.abs().max()))


def test_two_cell_slabs_s8():
    """S = 8 at r = 4: two-cell slabs on the fine level, one-cell slabs
    at r = 3, where off-by-one halo faults live; float64 sumfac against
    the single-device solve."""
    x, st = ShardedGeometricPoisson(3, 2, 4, devices=[CPU] * 8).solve()
    x1, st1 = GeometricMultigridPoisson(3, 2, 4, torch.float64, "sumfac",
                                        device="cpu").solve()
    assert st.converged and st.iterations == st1.iterations
    assert st.n_shards == 8 and st.dofs_per_level[:3] == [27, 125, 729]
    np.testing.assert_allclose(x, x1.numpy(), rtol=0,
                               atol=1e-10 * float(x1.abs().max()))


def test_unreplicated_coarse_levels():
    """replicate_coarse=False: the hierarchy starts at one slab a shard."""
    x, st = ShardedGeometricPoisson(3, 2, 3, devices=[CPU] * 4,
                                    replicate_coarse=False).solve()
    assert st.converged and st.dofs_per_level[0] == 729


def test_sharded_polynomial_matches_single_device():
    x, st = ShardedPolynomialPoisson(3, 3, 3, 3, devices=[CPU] * 4).solve()
    x1, st1 = PolynomialMultigridPoisson(3, 3, 3, 3, torch.float64, "sumfac",
                                         device="cpu").solve()
    assert st.converged and st.iterations == st1.iterations
    np.testing.assert_allclose(x, x1.numpy(), rtol=0,
                               atol=1e-10 * float(x1.abs().max()))


def test_vector_fields_transfer_along_their_grid_axis():
    """A component-major vector field through ShardedTransfer with
    halo_axis=1 gives each component's scalar transfer (the exchange runs
    along the grid axis, not the component axis: fault 1f97bde), over two
    levels, S = 4 shards of one device batched."""
    from portable_multigrid_tpu_torch.parallel.poisson import (
        _build_stacked_h_transfer,
    )
    S, p = 4, 2
    spaces = [FESpace(HyperCubeMesh(3, r), p) for r in (2, 3, 4)]
    rng = np.random.default_rng(5)
    for coarse, fine in zip(spaces, spaces[1:]):
        scalar = _build_stacked_h_transfer(coarse, fine, [CPU] * S,
                                           torch.float64)
        vector = sharding.ShardedTransfer(local=scalar.local, halo_axis=1)
        nc, nf = coarse.mesh.cells_per_axis, fine.mesh.cells_per_axis
        c = rng.standard_normal((3,) + coarse.grid_shape)
        f = rng.standard_normal((3,) + fine.grid_shape)

        def vec(a, n):
            parts = [sharding.partition_axis0(a[k], n, p, S) for k in range(3)]
            return sharding.ShardedField(torch.from_numpy(np.stack(
                [parts[k][s] for k in range(3)])) for s in range(S))

        for name, src, n in (("prolongate", c, nc), ("restrict", f, nf)):
            got = getattr(vector, name)(vec(src, n))
            for k in range(3):
                want = getattr(scalar, name)(sharding.shard(
                    src[k], n, p, [CPU] * S, torch.float64))
                for s in range(S):
                    np.testing.assert_allclose(got.parts[s][k].numpy(),
                                               want.parts[s].numpy(),
                                               rtol=0, atol=1e-13)


def test_default_devices_need_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedGeometricPoisson(3, 2, 2)


def test_model_errors():
    with pytest.raises(ValueError, match="power of two"):
        ShardedGeometricPoisson(3, 2, 3, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="refinements"):
        ShardedGeometricPoisson(3, 2, 1, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="'pallas'"):
        ShardedGeometricPoisson(3, 2, 2, devices=[CPU], variant="pallas")
    with pytest.raises(ValueError, match="divisible"):
        ShardedPolynomialPoisson(3, 2, 1, devices=[CPU] * 4)


def test_partial_assembly_rows():
    """The slab-partial 1D matrices: every row sums to zero (K), they add
    up to the global assembly over the slabs, and the first and last
    rows carry one cell."""
    sp = FESpace(HyperCubeMesh(3, 3), 3)
    K, M = _partial_assembled_1d(sp, 2)
    np.testing.assert_allclose(K.sum(axis=1), 0.0, atol=1e-12 * abs(K).max())
    from portable_multigrid_tpu_torch.ops.laplace import assembled_1d_matrices
    K1, M1 = assembled_1d_matrices(sp)
    G = np.zeros_like(K1)
    for b0, b1 in sharding.slab_bounds(8, 3, 4):
        G[b0:b1, b0:b1] += K
    np.testing.assert_allclose(G, K1, atol=1e-12 * abs(K1).max())
    jK, jM = jpoisson._partial_assembled_1d(JSpace(JMesh(3, 3), 3), 2)
    np.testing.assert_array_equal(K, jK)
    np.testing.assert_array_equal(M, jM)


def test_driver_sharded_prints_golden_counts():
    proc = subprocess.run(
        [sys.executable, "-m",
         "portable_multigrid_tpu_torch.programs.geometric_multigrid",
         "--sharded", "--device", "cpu", "--max-degree", "2", "--cycles",
         "2"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    its = [int(v) for v in re.findall(r"converged in (\d+) iterations",
                                      proc.stdout)]
    want = [_golden(p, r)["iterations"] for p in (1, 2) for r in (1, 2)]
    assert its == want
    assert "Number of degrees of freedom: 729 over 1 shards (by level: 27, " \
           "125, 729)" in proc.stdout
    assert "solution norm: 0.0233796" in proc.stdout


def test_parallel_never_imports_jax():
    """No module of the port, nor chip_smoke.py, imports jax or the JAX
    package: a child process imports every port module, and a grep of the
    sources finds no such import."""
    pkg = ROOT / "portable_multigrid_tpu_torch"
    mods = sorted(".".join(path.relative_to(ROOT).with_suffix("").parts)
                  for path in pkg.rglob("*.py"))
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m == 'jax' or "
              "m.startswith('jax.') or m == 'portable_multigrid_tpu' or "
              "m.startswith('portable_multigrid_tpu.')]\n"
              "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax\b|portable_multigrid_tpu"
                         r"\b(?!_torch))", re.M)
    for path in list(pkg.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path
