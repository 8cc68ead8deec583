"""The port's NumPy fem modules are bit-equal copies of the JAX package's."""

import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem import assemble as jassemble
from portable_multigrid_tpu.fem import basis as jbasis
from portable_multigrid_tpu.fem import mesh as jmesh
from portable_multigrid_tpu.fem import space as jspace
from portable_multigrid_tpu_torch.fem import assemble as tassemble
from portable_multigrid_tpu_torch.fem import basis as tbasis
from portable_multigrid_tpu_torch.fem import mesh as tmesh
from portable_multigrid_tpu_torch.fem import space as tspace

torch.set_num_threads(1)

DEGREES = list(range(1, 8))


def _spaces(dim, r, p):
    return (jspace.FESpace(jmesh.HyperCubeMesh(dim, r), p),
            tspace.FESpace(tmesh.HyperCubeMesh(dim, r), p))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b)


@pytest.mark.parametrize("p", DEGREES)
def test_basis_bit_equal(p):
    jb, tb = jbasis.make_basis(p), tbasis.make_basis(p)
    for field in ("nodes", "q_points", "q_weights", "B", "D", "Dco"):
        _same(getattr(jb, field), getattr(tb, field))
    _same(jbasis.h_prolongation_matrix_1d(p), tbasis.h_prolongation_matrix_1d(p))
    _same(jbasis.p_prolongation_matrix_1d(1, p),
          tbasis.p_prolongation_matrix_1d(1, p))


@pytest.mark.parametrize("p", DEGREES)
def test_space_and_mesh_bit_equal(p):
    js, ts = _spaces(3, 2, p)
    assert js.grid_shape == ts.grid_shape and js.n_dofs == ts.n_dofs
    _same(js.free_mask_1d(), ts.free_mask_1d())
    _same(js.free_mask(), ts.free_mask())
    _same(js.dof_points_1d(), ts.dof_points_1d())
    _same(js.local_to_global(), ts.local_to_global())
    jseq = jmesh.geometric_coarsening_sequence(js.mesh)
    tseq = tmesh.geometric_coarsening_sequence(ts.mesh)
    assert [(m.refinements, m.h) for m in jseq] == [
        (m.refinements, m.h) for m in tseq]


@pytest.mark.parametrize("p", DEGREES)
def test_rhs_and_l2_norm_bit_equal(p):
    js, ts = _spaces(3, 2, p)
    _same(jassemble.assemble_rhs(js), tassemble.assemble_rhs(ts))
    f = lambda x, y, z: np.sin(3 * x) * y + z * z
    _same(jassemble.assemble_rhs(js, f=f), tassemble.assemble_rhs(ts, f=f))
    u = np.random.default_rng(p).standard_normal(js.grid_shape)
    assert jassemble.l2_norm(js, u) == tassemble.l2_norm(ts, u)


@pytest.mark.parametrize("p", DEGREES)
def test_dense_oracles_bit_equal(p):
    js, ts = _spaces(2, 2, p)
    _same(jassemble.dense_operator(js), tassemble.dense_operator(ts))
    jc, tc = _spaces(2, 1, p)
    _same(jassemble.dense_prolongation(jc, js),
          tassemble.dense_prolongation(tc, ts))
