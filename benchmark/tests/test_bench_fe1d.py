"""The assembled 1D gradient matrix C[i, j] = int l_i l_j'
(``pmgbench.fe1d.assembled_gradient``)."""

import numpy as np
import pytest

from pmgbench import fe1d

SIZES = [(1, 0), (2, 2), (3, 1), (4, 2), (7, 1)]


@pytest.mark.parametrize("degree,r", SIZES)
def test_gradient_of_a_constant_is_zero(degree, r):
    C = fe1d.assembled_gradient(degree, r)
    assert np.abs(C @ np.ones(len(C))).max() <= 1e-13 * np.abs(C).max()


@pytest.mark.parametrize("degree,r", SIZES)
def test_integration_by_parts(degree, r):
    """C + C^T = e_N e_N^T - e_0 e_0^T: int (l_i l_j)' = [l_i l_j] from 0
    to 1."""
    C = fe1d.assembled_gradient(degree, r)
    want = np.zeros_like(C)
    want[-1, -1], want[0, 0] = 1.0, -1.0
    assert np.abs(C + C.T - want).max() <= 1e-13


@pytest.mark.parametrize("degree,r", SIZES)
def test_exact_for_polynomials(degree, r):
    """u^T C v = int_0^1 u v' for polynomials u, v of degree <= p, which
    their nodal values hold exactly."""
    P = np.polynomial.Polynomial
    rng = np.random.default_rng(degree * 10 + r)
    u, v = P(rng.standard_normal(degree + 1)), P(rng.standard_normal(
        degree + 1))
    nodes = np.concatenate([
        c + fe1d.lobatto_nodes(degree)[:-1] for c in range(1 << r)] + [[
            1 << r]]) / (1 << r)
    assert len(nodes) == fe1d.n_points(degree, r)
    C = fe1d.assembled_gradient(degree, r)
    got = u(nodes) @ C @ v(nodes)
    exact = (u * v.deriv()).integ()
    want = exact(1.0) - exact(0.0)
    assert abs(got - want) <= 1e-12 * max(1.0, abs(want))
