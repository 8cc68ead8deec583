"""The port's general-geometry models against the JAX package's, float64 on
the CPU: ``UnstructuredMultigrid`` and ``GeneralGeometryMultigrid`` at the
JAX tests' sizes (tests/test_unstructured_mg.py, tests/test_indexed.py:
the same CG counts, x within 1e-10 of max |x|, and within 1e-9 of the dense
oracle's solve), ``CurvedMultigrid`` against the JAX package's counts,
norms and L2 errors pinned below (its JAX run is in the slow set), and the
pieces: ``coarsen_vertex_grid``, ``FlatTransfer``, ``output_vtu``.

The pinned curved values are the JAX package's, as this prints them from
the repo root (~20 s):

    python -c "import jax, sys; jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True); sys.path.insert(0, 'tests')
    from test_curved import _annulus, _f, _u_exact
    from portable_multigrid_tpu.models.general_geometry import CurvedMultigrid
    for r in (2, 3):
        p = CurvedMultigrid(2, 3, r, _annulus); x, s = p.solve(_f)
        print(r, s.iterations, repr(s.solution_l2_norm),
              repr(p.l2_error(x, _u_exact)))"
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem import general_mesh as jgm
from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.models import general_geometry as jmodels
from portable_multigrid_tpu.ops.transfer import make_h_transfer as j_h_transfer
from portable_multigrid_tpu_torch.fem.assemble import assemble_rhs_indexed
from portable_multigrid_tpu_torch.fem.general_mesh import perturbed_cube_mesh
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.models import general_geometry as models
from portable_multigrid_tpu_torch.ops.indexed import (
    dense_indexed_operator,
    dense_unstructured_operator,
)
from portable_multigrid_tpu_torch.ops.transfer import make_h_transfer

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_curved import _annulus, _f, _u_exact  # noqa: E402


@pytest.fixture(autouse=True)
def _default_settings(monkeypatch):
    """Every PMG_* setting at its default, whatever the environment holds
    (both packages' Chebyshev setups read PMG_EIG_MAX_ITERS)."""
    for key in [k for k in os.environ if k.startswith("PMG_")]:
        monkeypatch.delenv(key)


# r -> (CG iterations, solution L2 norm, L2 error): the JAX package's
# CurvedMultigrid(2, 3, r, _annulus).solve(_f), rtol 1e-12
CURVED_JAX = {2: (5, 5.999994457914078, 0.0001409566215156743),
              3: (6, 11.999999788416169, 8.976839260745935e-06)}


def _close_x(x, want, bound):
    want = np.asarray(want)
    err = np.abs(x.numpy() - want).max() / np.abs(want).max()
    assert err <= bound, err


@pytest.mark.parametrize("dim,degree,refs", [(2, 3, 2), (3, 2, 1)])
def test_unstructured_mg_matches_jax_and_dense(dim, degree, refs):
    prob = models.UnstructuredMultigrid(
        perturbed_cube_mesh(dim, 2, 0.15, 7), degree, refs, device="cpu")
    x, st = prob.solve()
    jx, jst = jmodels.UnstructuredMultigrid(
        jgm.perturbed_cube_mesh(dim, 2, 0.15, 7), degree, refs).solve()
    assert st.converged and st.iterations == jst.iterations <= 8
    assert st.n_dofs == jst.n_dofs and st.dofs_per_level == jst.dofs_per_level
    _close_x(x, jx, 1e-10)
    assert st.solution_l2_norm == pytest.approx(jst.solution_l2_norm,
                                                rel=1e-10)
    gm = prob.meshes[-1]
    n_dofs, l2g, mask = prob.dof_packs[-1]
    rhs = assemble_rhs_indexed(gm, l2g, degree, n_dofs, mask,
                               lambda *c: np.ones_like(c[0]))
    _close_x(x, np.linalg.solve(dense_unstructured_operator(gm, degree),
                                rhs), 1e-9)
    assert set(prob.setup_seconds) == {"refine", "enumerate", "operators",
                                       "eigenvalues", "transfers"}


def test_general_geometry_mg_matches_jax_and_dense():
    gm = perturbed_cube_mesh(2, 8, amplitude=0.15)
    prob = models.GeneralGeometryMultigrid(gm, 2, 3, device="cpu")
    x, st = prob.solve()
    jx, jst = jmodels.GeneralGeometryMultigrid(
        jgm.perturbed_cube_mesh(2, 8, amplitude=0.15), 2, 3).solve()
    assert st.converged and st.iterations == jst.iterations <= 12
    assert st.dofs_per_level == jst.dofs_per_level
    _close_x(x, jx, 1e-10)
    sp = FESpace(HyperCubeMesh(2, 3), 2)
    b = (np.random.default_rng(0).standard_normal(sp.n_dofs)
         * sp.free_mask().reshape(-1))
    _close_x(x, np.linalg.solve(dense_indexed_operator(sp, gm), b), 1e-9)
    # the eager solve is the same solve on the CPU
    x2, st2 = prob.solve(graph=False)
    assert st2.iterations == st.iterations and torch.equal(x, x2)


@pytest.mark.parametrize("r", [2, 3])
def test_curved_mg_matches_pinned_jax(r):
    prob = models.CurvedMultigrid(2, 3, r, _annulus, device="cpu")
    x, st = prob.solve(_f)
    its, norm, err = CURVED_JAX[r]
    assert st.converged and st.iterations == its
    assert st.solution_l2_norm == pytest.approx(norm, rel=1e-10)
    assert prob.l2_error(x, _u_exact) == pytest.approx(err, rel=1e-9)
    assert prob.mapping_degree == 3 and len(prob.geos) == r + 1


def test_curved_rate_through_the_mg_solve():
    errs = []
    for r in (2, 3):
        prob = models.CurvedMultigrid(2, 3, r, _annulus, device="cpu")
        errs.append(prob.l2_error(prob.solve(_f)[0], _u_exact))
    assert np.log2(errs[0] / errs[1]) > 3 + 0.6


@pytest.mark.parametrize("dim,n", [(2, 8), (3, 4)])
def test_coarsen_vertex_grid_equals_jax(dim, n):
    gm = perturbed_cube_mesh(dim, n, amplitude=0.2)
    jg = jgm.perturbed_cube_mesh(dim, n, amplitude=0.2)
    a = models.coarsen_vertex_grid(gm, dim, n)
    b = jmodels.coarsen_vertex_grid(jg, dim, n)
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.cells, b.cells)


def test_flat_transfer_equals_jax():
    c_sp, f_sp = FESpace(HyperCubeMesh(2, 1), 3), FESpace(HyperCubeMesh(2, 2), 3)
    jc, jf = JSpace(JMesh(2, 1), 3), JSpace(JMesh(2, 2), 3)
    tr = models.FlatTransfer(c_sp.grid_shape, f_sp.grid_shape,
                             make_h_transfer(c_sp, f_sp))
    jtr = jmodels.FlatTransfer(coarse_shape=jc.grid_shape,
                               fine_shape=jf.grid_shape,
                               inner=j_h_transfer(jc, jf, jnp.float64))
    rng = np.random.default_rng(2)
    c = rng.standard_normal(c_sp.n_dofs)
    f = rng.standard_normal(f_sp.n_dofs)
    np.testing.assert_allclose(tr.prolongate(torch.as_tensor(c)).numpy(),
                               np.asarray(jtr.prolongate(jnp.asarray(c))),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(tr.restrict(torch.as_tensor(f)).numpy(),
                               np.asarray(jtr.restrict(jnp.asarray(f))),
                               rtol=0, atol=1e-13)


def test_output_vtu_equals_jax(tmp_path):
    """The same solution vector gives the JAX package's file byte for byte,
    for the unstructured and the deformed model."""
    port = models.UnstructuredMultigrid(perturbed_cube_mesh(2, 2, 0.15, 7),
                                        2, 1, device="cpu")
    jax_ = jmodels.UnstructuredMultigrid(
        jgm.perturbed_cube_mesh(2, 2, 0.15, 7), 2, 1)
    u = np.random.default_rng(4).standard_normal(port.dof_packs[-1][0])
    port.output_vtu(str(tmp_path / "a.vtu"), torch.as_tensor(u))
    jax_.output_vtu(str(tmp_path / "b.vtu"), u)
    assert (tmp_path / "a.vtu").read_bytes() == (tmp_path / "b.vtu").read_bytes()
    port = models.GeneralGeometryMultigrid(perturbed_cube_mesh(2, 4), 2, 2,
                                           device="cpu")
    jax_ = jmodels.GeneralGeometryMultigrid(jgm.perturbed_cube_mesh(2, 4), 2, 2)
    u = np.random.default_rng(5).standard_normal(port.spaces[-1].n_dofs)
    port.output_vtu(str(tmp_path / "c.vtu"), torch.as_tensor(u))
    jax_.output_vtu(str(tmp_path / "d.vtu"), u)
    assert (tmp_path / "c.vtu").read_bytes() == (tmp_path / "d.vtu").read_bytes()


def test_models_default_to_the_card():
    import inspect

    for model in (models.UnstructuredMultigrid,
                  models.GeneralGeometryMultigrid, models.CurvedMultigrid):
        params = inspect.signature(model.__init__).parameters
        assert params["device"].default == "cuda"
        assert params["dtype"].default == torch.float64
