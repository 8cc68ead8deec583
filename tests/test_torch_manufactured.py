"""``l2_error`` and the manufactured-solution oracle on the port (ROADMAP
A.15), float64 on the CPU.

The port's ``l2_error``, ``l2_error_indexed``, ``assemble_rhs_indexed`` and
``_tensor_basis_values`` against the JAX package's on the same arrays
(1e-12 relative), and the rate of the port's own solves: u(x) =
prod_d sin(pi x_d), -Δu = dim pi² u, homogeneous Dirichlet on the unit
hyper-cube, whose Q_p L2 error must fall at rate h^(p+1)
(tests/test_manufactured.py holds the JAX package to p + 0.7; so is the
port held here, at 2D Q2 r=2 -> 3 and 3D Q2 r=1 -> 2).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from portable_multigrid_tpu.fem import assemble as jassemble
from portable_multigrid_tpu.fem import general_mesh as jgm
from portable_multigrid_tpu.fem.mesh import HyperCubeMesh as JMesh
from portable_multigrid_tpu.fem.space import FESpace as JSpace
from portable_multigrid_tpu_torch.fem import assemble, general_mesh
from portable_multigrid_tpu_torch.fem.basis import gauss_points
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.models.poisson import (
    GeometricMultigridPoisson,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _default_settings(monkeypatch):
    """Every PMG_* setting at its default, whatever the environment holds
    (both packages' Chebyshev setups read PMG_EIG_MAX_ITERS; the
    structured solve reads PMG_CHEB2 and PMG_CHEB2R)."""
    for key in [k for k in os.environ if k.startswith("PMG_")]:
        monkeypatch.delenv(key)


def _u_exact(*coords):
    out = 1.0
    for c in coords:
        out = out * np.sin(np.pi * c)
    return out


def _annulus(s, t):
    r = 1.0 + s
    return r * np.cos(t * np.pi / 2), r * np.sin(t * np.pi / 2)


@pytest.mark.parametrize("dim,p,r", [(1, 3, 3), (2, 2, 2), (3, 2, 1),
                                     (3, 4, 1)])
def test_l2_error_equals_jax(dim, p, r):
    sp, jsp = FESpace(HyperCubeMesh(dim, r), p), JSpace(JMesh(dim, r), p)
    u = np.random.default_rng(dim * 10 + p).standard_normal(sp.grid_shape)
    for n_q in (None, p + 3):
        got = assemble.l2_error(sp, u, _u_exact, n_q)
        want = jassemble.l2_error(jsp, u, _u_exact, n_q)
        assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("geometry", ["perturbed2", "perturbed3", "curved"])
def test_indexed_functionals_equal_jax(geometry):
    if geometry == "curved":
        dim, p = 2, 3
        geo = general_mesh.curved_structured_geometry(2, 4, _annulus, 3)
        jgeo = jgm.curved_structured_geometry(2, 4, _annulus, 3)
        l2g = FESpace(HyperCubeMesh(2, 2), p).local_to_global()
    else:
        dim, p = int(geometry[-1]), 2
        geo = general_mesh.perturbed_cube_mesh(dim, 4, amplitude=0.2)
        jgeo = jgm.perturbed_cube_mesh(dim, 4, amplitude=0.2)
        l2g = FESpace(HyperCubeMesh(dim, 2), p).local_to_global()
    n = int(l2g.max()) + 1
    rng = np.random.default_rng(8)
    mask = (rng.uniform(size=n) > 0.2).astype(np.float64)
    f = lambda *c: 1.0 + np.cos(c[0]) * c[-1]  # noqa: E731
    np.testing.assert_allclose(
        assemble.assemble_rhs_indexed(geo, l2g, p, n, mask, f),
        jassemble.assemble_rhs_indexed(jgeo, l2g, p, n, mask, f),
        rtol=0, atol=1e-15)
    u = rng.standard_normal(n)
    for n_q in (None, p + 3):
        got = assemble.l2_error_indexed(geo, l2g, p, u, _u_exact, n_q)
        want = jassemble.l2_error_indexed(jgeo, l2g, p, u, _u_exact, n_q)
        assert got == pytest.approx(want, rel=1e-12)
    qp, _ = gauss_points(p + 1)
    np.testing.assert_array_equal(
        assemble._tensor_basis_values(p, qp, dim),
        jassemble._tensor_basis_values(p, qp, dim))


def _solve_error(dim, degree, refinements):
    prob = GeometricMultigridPoisson(dim, degree, refinements,
                                     dtype=torch.float64, device="cpu")
    f = lambda *c: dim * np.pi ** 2 * _u_exact(*c)  # noqa: E731
    x, st = prob.solve(f=f)
    assert st.converged
    return assemble.l2_error(prob.spaces[-1], x.numpy(), _u_exact)


@pytest.mark.parametrize("dim,degree,r0,r1", [(2, 2, 2, 3), (3, 2, 1, 2)])
def test_port_solves_converge_at_rate_p_plus_one(dim, degree, r0, r1):
    e0 = _solve_error(dim, degree, r0)
    e1 = _solve_error(dim, degree, r1)
    rate = np.log2(e0 / e1)
    assert e1 < e0 and rate > degree + 0.7, (e0, e1, rate)


def test_l2_error_of_the_interpolant_is_small():
    """The nodal interpolant of u at Q3 r=3 in 2D is within ~1e-5 of u in
    L2; a wrong quadrature grid or basis would give O(1)."""
    sp = FESpace(HyperCubeMesh(2, 3), 3)
    x1 = np.concatenate([[0.0]] + [
        (c + sp.basis.nodes[1:]) * sp.mesh.h
        for c in range(sp.mesh.cells_per_axis)])
    u = _u_exact(*np.meshgrid(x1, x1, indexing="ij"))
    err = assemble.l2_error(sp, u, _u_exact)
    assert 1e-7 < err < 1e-4
    assert err == pytest.approx(jassemble.l2_error(
        JSpace(JMesh(2, 3), 3), jnp.asarray(u), _u_exact), rel=1e-12)
