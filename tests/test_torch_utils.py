"""The port's ``utils/``: ``write_vti``, ``write_vtu`` and ``vertex_values``
give the JAX package's bytes and arrays on the same inputs, and a
checkpoint round-trips (and reads back in the JAX package's loader)."""

import numpy as np
import pytest

from portable_multigrid_tpu.fem import general_mesh as jgm
from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu.utils import checkpoint as jcheckpoint
from portable_multigrid_tpu.utils import vtu as jvtu
from portable_multigrid_tpu_torch.fem.general_mesh import perturbed_cube_mesh
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.native import enumerate_dofs
from portable_multigrid_tpu_torch.utils import checkpoint, vtu


@pytest.mark.parametrize("dim,p,r", [(2, 2, 2), (3, 1, 2)])
def test_write_vti_bytes_equal_jax(tmp_path, dim, p, r):
    sp, jsp = FESpace(HyperCubeMesh(dim, r), p), JSpace(JMesh(dim, r), p)
    rng = np.random.default_rng(dim)
    fields = {"solution": rng.standard_normal(sp.grid_shape),
              "velocity": rng.standard_normal((dim,) + sp.grid_shape)}
    vtu.write_vti(str(tmp_path / "a.vti"), sp, fields)
    jvtu.write_vti(str(tmp_path / "b.vti"), jsp, fields)
    assert (tmp_path / "a.vti").read_bytes() == (tmp_path / "b.vti").read_bytes()
    with pytest.raises(ValueError, match="bad field shape"):
        vtu.write_vti(str(tmp_path / "c.vti"), sp, {"u": np.zeros(3)})


@pytest.mark.parametrize("dim,degree", [(2, 3), (3, 2)])
def test_write_vtu_and_vertex_values_equal_jax(tmp_path, dim, degree):
    gm = perturbed_cube_mesh(dim, 2, amplitude=0.15, seed=9)
    jg = jgm.GeneralMesh(gm.vertices, gm.cells)
    n_dofs, l2g, mask = enumerate_dofs(gm, degree)
    u = np.random.default_rng(0).standard_normal(n_dofs)
    vv = vtu.vertex_values(gm, degree, l2g, u)
    np.testing.assert_array_equal(vv, jvtu.vertex_values(jg, degree, l2g, u))
    fields = {"solution": vv, "mask_v": vtu.vertex_values(gm, degree, l2g,
                                                          mask)}
    vtu.write_vtu(str(tmp_path / "a.vtu"), gm, fields)
    jvtu.write_vtu(str(tmp_path / "b.vtu"), jg, fields)
    assert (tmp_path / "a.vtu").read_bytes() == (tmp_path / "b.vtu").read_bytes()
    with pytest.raises(ValueError, match="per-vertex"):
        vtu.write_vtu(str(tmp_path / "c.vtu"), gm, {"u": u})


def test_checkpoint_round_trip(tmp_path):
    arrays = {"x": np.random.default_rng(1).standard_normal((5, 7)),
              "levels": np.arange(4, dtype=np.int64)}
    meta = {"iterations": 4, "rtol": 1e-12, "model": "UnstructuredMultigrid"}
    path = str(tmp_path / "state.npz")
    checkpoint.save_checkpoint(path, arrays, meta)
    for load in (checkpoint.load_checkpoint, jcheckpoint.load_checkpoint):
        got, got_meta = load(path)
        assert got_meta == meta and set(got) == set(arrays)
        for k, v in arrays.items():
            np.testing.assert_array_equal(got[k], v)
            assert got[k].dtype == v.dtype
    # no metadata: an empty dict back; no temporary file left beside it
    checkpoint.save_checkpoint(path, {"x": arrays["x"]})
    assert checkpoint.load_checkpoint(path)[1] == {}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["state.npz"]
