"""The port's indexed (general-geometry) operator and transfer against the
JAX package's, float64, on the CPU: the apply and the transfers on the same
state (``convert.indexed_operator`` / ``indexed_transfer``) and from each
package's own setup within 1e-12 relative, the diagonal, the dense oracles,
restrict as the exact transpose of prolongate, the Cartesian case against
the port's structured operator, and the deterministic scatter."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem import general_mesh as jgm
from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.native import enumerate_dofs as j_enumerate
from portable_multigrid_tpu.ops import indexed as jidx
from portable_multigrid_tpu_torch import convert
from portable_multigrid_tpu_torch.fem import general_mesh
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.native import enumerate_dofs
from portable_multigrid_tpu_torch.ops import indexed
from portable_multigrid_tpu_torch.ops.laplace import make_laplace

torch.set_num_threads(1)

R0, R1, TH = 1.0, 2.0, np.pi / 2


def _annulus(s, t):
    r = R0 + s * (R1 - R0)
    return r * np.cos(t * TH), r * np.sin(t * TH)


def _geometry(kind, dim, n, mod):
    """The geometry of each operator kind, from the module ``mod``."""
    if kind == "cartesian":
        return None
    if kind == "perturbed":
        return mod.perturbed_cube_mesh(dim, n, amplitude=0.2)
    return mod.curved_structured_geometry(2, n, _annulus, 3)


# (kind, dim, degree, refinements)
STRUCTURED = [("cartesian", 2, 2, 2), ("cartesian", 3, 2, 1),
              ("perturbed", 2, 3, 2), ("perturbed", 3, 2, 2),
              ("curved", 2, 3, 2)]


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _pair(kind, dim, p, r):
    """(port operator, JAX operator) on the same space and geometry."""
    sp, jsp = FESpace(HyperCubeMesh(dim, r), p), JSpace(JMesh(dim, r), p)
    n = 1 << r
    return (indexed.make_indexed_laplace(sp, _geometry(kind, dim, n,
                                                       general_mesh)),
            jidx.make_indexed_laplace(jsp, _geometry(kind, dim, n, jgm)),
            sp)


@pytest.mark.parametrize("kind,dim,p,r", STRUCTURED)
def test_structured_apply_equals_jax(kind, dim, p, r):
    op, jop, sp = _pair(kind, dim, p, r)
    u = np.random.default_rng(0).standard_normal(sp.n_dofs)
    want = np.asarray(jop.apply(jnp.asarray(u)))
    assert _rel(op.apply(torch.as_tensor(u)), want) <= 1e-12
    # the same state carried over from the JAX operator
    cop = convert.indexed_operator(jop)
    assert _rel(cop.apply(torch.as_tensor(u)), want) <= 1e-12
    np.testing.assert_allclose(op.inv_diag.numpy(), np.asarray(jop.inv_diag),
                               rtol=1e-12)
    assert op.shape == (sp.n_dofs,) and op.dtype == torch.float64
    assert op.l2g.dtype == torch.int64 and op.scatter.dtype == torch.int64


@pytest.mark.parametrize("kind,dim,p,r", STRUCTURED[2:])
def test_dense_indexed_oracle_equals_jax(kind, dim, p, r):
    n = 1 << r
    a = indexed.dense_indexed_operator(
        FESpace(HyperCubeMesh(dim, r), p), _geometry(kind, dim, n,
                                                     general_mesh))
    b = jidx.dense_indexed_operator(
        JSpace(JMesh(dim, r), p), _geometry(kind, dim, n, jgm))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-13 * np.abs(b).max())


@pytest.mark.parametrize("dim,p,r", [(1, 2, 2), (2, 2, 2), (3, 2, 1),
                                     (3, 3, 1)])
def test_cartesian_equals_structured(dim, p, r):
    sp = FESpace(HyperCubeMesh(dim, r), p)
    oi = indexed.make_indexed_laplace(sp)
    os_ = make_laplace(sp, torch.float64, "kron")
    u = torch.as_tensor(np.random.default_rng(0).standard_normal(
        sp.grid_shape))
    a = oi.apply(u.reshape(-1)).reshape(sp.grid_shape)
    b = os_.apply(u)
    assert _rel(a, b) <= 1e-13
    np.testing.assert_allclose(oi.inv_diag.reshape(sp.grid_shape).numpy(),
                               os_.inv_diag.numpy(), rtol=1e-12)


def _unstructured(dim, p, seed=5):
    gm = general_mesh.perturbed_cube_mesh(dim, 2, amplitude=0.2, seed=seed)
    fine = general_mesh.refine_general_mesh(gm)
    return gm, fine, enumerate_dofs(gm, p), enumerate_dofs(fine, p)


@pytest.mark.parametrize("dim,p", [(2, 3), (3, 2)])
def test_unstructured_operator_and_transfer_equal_jax(dim, p):
    gm, fine, cpack, fpack = _unstructured(dim, p)
    jg = jgm.perturbed_cube_mesh(dim, 2, amplitude=0.2, seed=5)
    jfine = jgm.refine_general_mesh(jg)
    jcpack, jfpack = j_enumerate(jg, p), j_enumerate(jfine, p)
    op = indexed.make_unstructured_laplace(fine, p, dofs=fpack)
    jop = jidx.make_unstructured_laplace(jfine, p, dofs=jfpack)
    tr = indexed.make_unstructured_h_transfer(gm, p, cpack, fpack)
    jtr = jidx.make_unstructured_h_transfer(jg, p, jcpack, jfpack)
    rng = np.random.default_rng(1)
    u = rng.standard_normal(fpack[0])
    c = rng.standard_normal(cpack[0])
    for port_op, port_tr in ((op, tr), (convert.indexed_operator(jop),
                                        convert.indexed_transfer(jtr))):
        assert _rel(port_op.apply(torch.as_tensor(u)),
                    jop.apply(jnp.asarray(u))) <= 1e-12
        assert _rel(port_tr.prolongate(torch.as_tensor(c)),
                    jtr.prolongate(jnp.asarray(c))) <= 1e-12
        assert _rel(port_tr.restrict(torch.as_tensor(u)),
                    jtr.restrict(jnp.asarray(u))) <= 1e-12
    np.testing.assert_allclose(op.inv_diag.numpy(), np.asarray(jop.inv_diag),
                               rtol=1e-12)
    d = torch.as_tensor(u)
    assert _rel(tr.prolongate_and_add(d, torch.as_tensor(c)),
                d + tr.prolongate(torch.as_tensor(c))) == 0.0
    cc = torch.as_tensor(c)
    assert _rel(tr.restrict_and_add(cc, d), cc + tr.restrict(d)) == 0.0


@pytest.mark.parametrize("dim,p", [(2, 3), (3, 2)])
def test_restrict_is_the_transpose_of_prolongate(dim, p):
    gm, _, cpack, fpack = _unstructured(dim, p)
    tr = indexed.make_unstructured_h_transfer(gm, p, cpack, fpack)
    P = torch.stack([tr.prolongate(e) for e in torch.eye(cpack[0],
                                                         dtype=torch.float64)],
                    dim=1)
    R = torch.stack([tr.restrict(e) for e in torch.eye(fpack[0],
                                                       dtype=torch.float64)],
                    dim=1)
    np.testing.assert_allclose(R.numpy(), P.T.numpy(), rtol=0, atol=1e-14)
    # with the masks lifted, prolongation reproduces constants
    ones = ((cpack[0], cpack[1], np.ones(cpack[0])),
            (fpack[0], fpack[1], np.ones(fpack[0])))
    tr1 = indexed.make_unstructured_h_transfer(gm, p, *ones)
    pc = tr1.prolongate(torch.ones(cpack[0], dtype=torch.float64))
    np.testing.assert_allclose(pc.numpy(), 1.0, atol=1e-12)


def test_unstructured_dense_oracle_equals_jax_and_apply():
    gm = general_mesh.perturbed_cube_mesh(2, 4, amplitude=0.2)
    A = indexed.dense_unstructured_operator(gm, 3)
    B = jidx.dense_unstructured_operator(
        jgm.perturbed_cube_mesh(2, 4, amplitude=0.2), 3)
    np.testing.assert_allclose(A, B, rtol=0, atol=1e-13 * np.abs(B).max())
    op = indexed.make_unstructured_laplace(gm, 3)
    u = np.random.default_rng(0).standard_normal(op.n_dofs)
    assert _rel(op.apply(torch.as_tensor(u)), A @ u) <= 1e-12
    np.testing.assert_allclose(1.0 / op.inv_diag.numpy(), np.diag(A),
                               rtol=1e-12)


def test_scatter_table_sums_like_add_at():
    rng = np.random.default_rng(3)
    l2g = rng.integers(0, 50, size=(40, 9))
    l2g[:, 0] = np.arange(40)  # every target up to 39 appears
    n = 60  # targets 50..59 have no entry
    table = indexed.scatter_table(l2g, n)
    counts = np.bincount(l2g.reshape(-1), minlength=n)
    assert table.shape == (counts.max(), n) and table.dtype == np.int64
    v = rng.standard_normal(l2g.shape)
    want = np.zeros(n)
    np.add.at(want, l2g.reshape(-1), v.reshape(-1))
    got = indexed.scatter_sum(torch.as_tensor(v), torch.as_tensor(table))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=1e-14)
    again = indexed.scatter_sum(torch.as_tensor(v), torch.as_tensor(table))
    assert torch.equal(got, again)
    # the k-th entry of each target, in flat order
    flat = l2g.reshape(-1)
    for j in (0, 7, 39):
        np.testing.assert_array_equal(table[:counts[j], j],
                                      np.flatnonzero(flat == j))
        assert (table[counts[j]:, j] == flat.size).all()


def test_construction_errors():
    sp = FESpace(HyperCubeMesh(2, 2), 2)
    with pytest.raises(ValueError, match="does not match"):
        indexed.make_indexed_laplace(
            sp, general_mesh.perturbed_cube_mesh(2, 2))
    gm, fine, cpack, fpack = _unstructured(2, 2)
    with pytest.raises(ValueError, match="refinement"):
        indexed.make_unstructured_h_transfer(gm, 2, cpack, cpack)
