"""The harness's slab layout of a multi-card cell (``pmgbench/slabs.py``)
against the program's (``parallel/sharding.py``), the gather and the
shared-plane reading, and the set-up's check of a model's slabs."""

import numpy as np
import pytest
import torch

from pmgbench import slabs, spec
from pmgbench.session import Session, program_class
from portable_multigrid_tpu_torch.parallel import sharding
from portable_multigrid_tpu_torch.parallel.poisson import (
    ShardedGeometricPoisson,
)

CASES = [(2, 3, 3, 2), (2, 7, 2, 4), (3, 2, 3, 4), (3, 4, 2, 2),
         (3, 1, 3, 8)]


@pytest.mark.parametrize("dim,degree,r,S", CASES)
def test_layout_is_the_programs(dim, degree, r, S):
    """Bounds and shapes equal ``slab_bounds`` and ``partition_axis0``'s;
    the gather of a consistent field equals ``unpartition_axis0``, and any
    block of planes equals the whole field's."""
    cfg = {"dim": dim, "degree": degree, "refinements": r}
    n = (1 << r) * degree + 1
    assert slabs.bounds(cfg, S) == sharding.slab_bounds(1 << r, degree, S)
    g = torch.as_tensor(np.random.default_rng(S).standard_normal((n,) * dim))
    parts = list(sharding.partition_axis0(g, 1 << r, degree, S))
    assert [tuple(t.shape) for t in parts] == slabs.shapes(cfg, S)
    whole = slabs.gather(parts, "cpu")
    assert torch.equal(whole, g)
    assert torch.equal(whole, sharding.unpartition_axis0(parts, 1 << r,
                                                         degree, S))
    for i0, i1 in ((0, 1), (0, n), (1, n - 1), (n // 3, n // 2 + 2)):
        got = slabs.planes(parts, i0, i1, "cpu", torch.float32)
        assert got.dtype == torch.float32
        assert torch.equal(got, g[i0:i1].to(torch.float32))
    assert slabs.shared_planes(parts) == 0.0


def test_bounds_refuse_an_uneven_split():
    with pytest.raises(ValueError, match="tiny.*3 slabs"):
        slabs.bounds({"name": "tiny", "dim": 3, "degree": 2,
                      "refinements": 1}, 3)


def test_gather_takes_the_left_owner():
    """Each shared plane of the gather is the left slab's copy; the right
    copy's difference is what ``shared_planes`` reads, over max |x|."""
    cfg = {"dim": 2, "degree": 2, "refinements": 2}
    g = torch.arange(81, dtype=torch.float64).reshape(9, 9)
    parts = [t.clone() for t in sharding.partition_axis0(g, 4, 2, 2)]
    parts[1][0] += 0.5
    assert torch.equal(slabs.gather(parts, "cpu"), g)
    assert slabs.shared_planes(parts) == pytest.approx(0.5 / 80)
    parts[0][-1] += 1.0  # the left copy off: the gather shows it
    assert slabs.gather(parts, "cpu")[4, 0] == g[4, 0] + 1.0
    assert slabs.shapes(cfg, 2) == [(5, 9), (5, 9)]


def test_program_class_by_dotted_name():
    assert program_class("parallel.ShardedGeometricPoisson") is \
        ShardedGeometricPoisson
    assert program_class("parallel.poisson.ShardedGeometricPoisson") is \
        ShardedGeometricPoisson
    from portable_multigrid_tpu_torch import GeometricMultigridPoisson

    assert program_class("GeometricMultigridPoisson") is \
        GeometricMultigridPoisson
    with pytest.raises(AttributeError, match="parallel.NoSuchModel"):
        program_class("parallel.NoSuchModel")


def _sharded_cell(checkout, kwargs):
    cell = spec.load_cell(checkout, "tiny3d.f64_tight")
    cell.chips = 2
    cell.config = {"name": "slabbed", "dim": 3, "degree": 2,
                   "refinements": 2, "reference": "laplace",
                   "models": {"float64": {
                       "class": "parallel.ShardedGeometricPoisson",
                       "kwargs": dict({"dim": 3, "degree": 2,
                                       "refinements": 2,
                                       "dtype": "float64"}, **kwargs)}}}
    return cell


def test_session_builds_on_the_cells_devices(checkout):
    cell = _sharded_cell(checkout, {})
    run = Session(cell, "cpu")
    assert run.devices == [torch.device("cpu")] * 2
    assert run.n_dofs == 9 ** 3 and run.dtype == torch.float64
    b = run.stream(7).next_rhs()
    assert [tuple(t.shape) for t in b] == [(5, 9, 9)] * 2
    res = run.solve(b)
    assert res.converged
    assert [tuple(t.shape) for t in run.held(res.x)] == [(5, 9, 9)] * 2
    with pytest.raises(ValueError, match="takes 2 cards, given 3"):
        Session(cell, ["cpu"] * 3)


def test_session_refuses_other_slabs(checkout):
    """A model whose fine level is not the configuration's grid fails in
    set-up, naming the configuration and S."""
    cell = _sharded_cell(checkout, {"degree": 3})
    with pytest.raises(ValueError, match=r"slabbed on S = 2 cards"):
        Session(cell, "cpu")
