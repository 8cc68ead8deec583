"""The closed loop's right-hand sides (``pmgbench/traffic.py``)."""

import json

import numpy as np
import pytest
import torch

from conftest import BENCH
from pmgbench import traffic
from portable_multigrid_tpu_torch.fem.assemble import assemble_rhs
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace

MIX = json.loads((BENCH / "traffic" / "rhs_stream.json").read_text())


def stream(dim, seed, degree=2, r=2, dtype=torch.float64):
    cfg = {"dim": dim, "degree": degree, "refinements": r}
    return traffic.SourceStream(MIX, cfg, dtype, "cpu", seed)


@pytest.mark.parametrize("dim", [2, 3])
def test_same_seed_same_rhs(dim):
    seed = 2**31 + 17
    a, b, c = stream(dim, seed), stream(dim, seed), stream(dim, seed + 1)
    for _ in range(3):
        x, y, z = a.next_rhs(), b.next_rhs(), c.next_rhs()
        assert torch.equal(x, y)
        assert not torch.equal(x, z)
    assert torch.equal(a.rhs(1), b.rhs(1))


@pytest.mark.parametrize("dim", [2, 3])
def test_zero_on_constrained_dofs(dim):
    b = stream(dim, 5).next_rhs().numpy()
    for ax in range(dim):
        for end in (0, -1):
            assert not np.take(b, end, axis=ax).any()
    assert np.abs(b).max() > 0


@pytest.mark.parametrize("dim", [2, 3])
def test_constant_source_is_the_programs_rhs(dim):
    """f = 1 against the program's host ``assemble_rhs`` at Q2 r=2."""
    space = FESpace(HyperCubeMesh(dim, 2), 2)
    want = assemble_rhs(space)
    got = stream(dim, 1).constant_rhs().numpy()
    assert np.abs(got - want).max() <= 1e-15 * np.abs(want).max()


@pytest.mark.parametrize("dim", [2, 3])
def test_mode_sources_match_the_programs_rhs(dim):
    """A drawn source against ``assemble_rhs`` of the same f at Q3 r=2."""
    s = stream(dim, 9, degree=3)
    got = s.next_rhs().numpy()
    c = s.coefficients[0]

    def f(*x):
        v = c[0] * np.ones_like(x[0])
        for a, m in zip(c[1:], MIX["source"]["modes"]):
            v = v + a * np.prod([np.sin(np.pi * k * xd)
                                 for k, xd in zip(m, x)], axis=0)
        return v

    want = assemble_rhs(FESpace(HyperCubeMesh(dim, 2), 3), f)
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()


def test_rhs_in_the_solve_dtype():
    assert stream(3, 1, dtype=torch.float32).next_rhs().dtype == torch.float32
