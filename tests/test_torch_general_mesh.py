"""The port's general-mesh layer against the JAX package's: the NumPy copies
of ``fem/general_mesh.py`` and ``fem/dof_numbering.py`` give the same
arrays (``assert_array_equal``: the same NumPy code), the native DoF
enumerator gives the Python one's tables and the JAX package's, and its
library is built into ``build/native/`` at the repository root, never
inside the package."""

import glob
import os

import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem import dof_numbering as jdofs
from portable_multigrid_tpu.fem import general_mesh as jgm
from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.native import (
    enumerate_dofs_native as j_enumerate_native,
)
from portable_multigrid_tpu_torch import native
from portable_multigrid_tpu_torch.fem import dof_numbering, general_mesh
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _annulus(s, t):
    r = 1.0 + s
    return r * np.cos(t * np.pi / 2), r * np.sin(t * np.pi / 2)


def _rotated(mesh, mod, seed):
    """Every cell re-oriented by a random rotation of the reference cube
    (tests/test_dof_numbering.py's ``rotate_cells``), as the module's own
    GeneralMesh."""
    import sys

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from test_dof_numbering import rotate_cells

    r = rotate_cells(jgm.GeneralMesh(mesh.vertices, mesh.cells), seed=seed)
    return mod.GeneralMesh(r.vertices, r.cells)


@pytest.mark.parametrize("dim,n,nq", [(1, 4, 3), (2, 4, 3), (3, 2, 4)])
def test_perturbed_mesh_and_tables_equal_jax(dim, n, nq):
    gm = general_mesh.perturbed_cube_mesh(dim, n, amplitude=0.2, seed=3)
    jg = jgm.perturbed_cube_mesh(dim, n, amplitude=0.2, seed=3)
    np.testing.assert_array_equal(gm.vertices, jg.vertices)
    np.testing.assert_array_equal(gm.cells, jg.cells)
    for a, b in zip(gm.geometry_tables(nq), jg.geometry_tables(nq)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(gm.physical_quad_points(nq),
                                  jg.physical_quad_points(nq))
    np.testing.assert_array_equal(gm.cell_vertices(), jg.cell_vertices())


@pytest.mark.parametrize("dim", [2, 3])
def test_refinement_equals_jax(dim):
    gm = general_mesh.perturbed_cube_mesh(dim, 2, amplitude=0.2, seed=5)
    jg = jgm.perturbed_cube_mesh(dim, 2, amplitude=0.2, seed=5)
    for _ in range(2 if dim == 2 else 1):
        gm, jg = (general_mesh.refine_general_mesh(gm),
                  jgm.refine_general_mesh(jg))
        np.testing.assert_array_equal(gm.vertices, jg.vertices)
        np.testing.assert_array_equal(gm.cells, jg.cells)
    assert gm.n_cells == jg.n_cells


@pytest.mark.parametrize("dim,r", [(1, 2), (2, 2), (3, 1)])
def test_structured_as_general_equals_jax(dim, r):
    a = general_mesh.structured_as_general(HyperCubeMesh(dim, r))
    b = jgm.structured_as_general(JMesh(dim, r))
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.cells, b.cells)


@pytest.mark.parametrize("q", [1, 3])
def test_curved_tables_equal_jax(q):
    a = general_mesh.curved_structured_geometry(2, 4, _annulus, q)
    b = jgm.curved_structured_geometry(2, 4, _annulus, q)
    np.testing.assert_array_equal(a.cell_points, b.cell_points)
    for x, y in zip(a.geometry_tables(q + 2), b.geometry_tables(q + 2)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.physical_quad_points(q + 2),
                                  b.physical_quad_points(q + 2))
    qp = np.linspace(0.1, 0.9, 3)
    for x, y in zip(general_mesh._tensor_shape_tables(a._nodes(), qp, 2),
                    jgm._tensor_shape_tables(b._nodes(), qp, 2)):
        np.testing.assert_array_equal(x, y)


def test_inverted_cells_are_refused():
    gm = general_mesh.perturbed_cube_mesh(2, 2, amplitude=0.0)
    flipped = general_mesh.GeneralMesh(gm.vertices, gm.cells[:, ::-1][:, [1, 0, 3, 2]])
    with pytest.raises(ValueError, match="inverted"):
        flipped.geometry_tables(2)


@pytest.mark.parametrize("dim,p,n,rotate", [(1, 3, 4, False), (2, 3, 4, True),
                                            (3, 2, 2, True), (3, 4, 2, True)])
def test_python_enumerator_equals_jax(dim, p, n, rotate):
    gm = general_mesh.perturbed_cube_mesh(dim, n, amplitude=0.15)
    if rotate:
        gm = _rotated(gm, general_mesh, seed=7)
    jg = jgm.GeneralMesh(gm.vertices, gm.cells)
    got = dof_numbering.enumerate_dofs(gm, p)
    want = jdofs.enumerate_dofs(jg, p)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("dim,p,n", [(2, 3, 4), (3, 2, 4), (3, 4, 2)])
def test_native_enumerator_equals_python_and_jax(dim, p, n):
    assert native.native_available()
    gm = _rotated(general_mesh.perturbed_cube_mesh(dim, n, amplitude=0.15),
                  general_mesh, seed=7)
    got = native.enumerate_dofs_native(gm.cells, dim, p)
    py = dof_numbering.enumerate_dofs(gm, p)
    jx = j_enumerate_native(gm.cells, dim, p)
    for want in (py, jx):
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])
    # the dispatcher takes the native path
    auto = native.enumerate_dofs(gm, p)
    np.testing.assert_array_equal(auto[1], got[1])


def test_native_valence_weights():
    sp = FESpace(HyperCubeMesh(3, 2), 2)
    l2g = sp.local_to_global()
    w = native.valence_weights_native(l2g, sp.n_dofs)
    counts = np.bincount(l2g.reshape(-1), minlength=sp.n_dofs)
    np.testing.assert_array_equal(w, 1.0 / counts)


def test_native_library_lands_in_build_native():
    native.get_lib()
    assert native.LIB_PATH == (native.BUILD_DIR / "libpmg_native.so")
    assert str(native.BUILD_DIR) == os.path.join(ROOT, "build", "native")
    assert native.LIB_PATH.exists()
    pkg = os.path.join(ROOT, "portable_multigrid_tpu_torch")
    written = [f for pat in ("*.so", "*.o", "*.dylib")
               for f in glob.glob(os.path.join(pkg, "**", pat),
                                  recursive=True)]
    assert written == []
