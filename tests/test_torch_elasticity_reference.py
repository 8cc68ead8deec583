"""The benchmark's plain elasticity reference
(``benchmark/configs/elasticity.py``) on the CPU, and the port's B.5 pass
counter (``ops/cuda_elasticity.py``, ``profiling.count``), with mu = 0.7,
lam = 1.3 and seeded random vectors.

* the reference's ``apply`` and ``solve`` against the dense assembled
  operator of ``benchmark/tests/elasticity_dense.py``; its CG count flat as
  the mesh is refined;
* ``ElasticityMultigrid``'s fine operator (``kron``, and ``auto``, B.5's
  plain twin on CPU tensors) against the reference's ``apply``, and a
  float64 solve against its ``solve``;
* the counter: nothing recorded outside ``tracing()``; under it, keys of the
  documented form, and per level of an eager V-cycle as many passes of
  each kind as ``pmgbench.elasticity_counts`` counts from the algorithm.
  The ``requires_cuda`` test holds a graphed V-cycle captured under
  tracing to the same counts.
"""

import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from portable_multigrid_tpu_torch import ElasticityMultigrid
from portable_multigrid_tpu_torch.ops import cuda_elasticity
from portable_multigrid_tpu_torch.solvers.cg import cg
from portable_multigrid_tpu_torch.utils import profiling

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
sys.path.append(str(BENCH))
from pmgbench import elasticity_counts  # noqa: E402
from pmgbench.spec import load_module  # noqa: E402

reference = load_module(BENCH / "configs" / "elasticity.py",
                        "elasticity_reference")
dense = load_module(BENCH / "tests" / "elasticity_dense.py",
                    "elasticity_dense")

torch.set_num_threads(1)

MU, LAM = 0.7, 1.3
KEY = re.compile(r"^pmg\.elasticity\.(apply|residual1t|residual3t|cheb|chebl"
                 r"|chebd|chebdl)/(mxu|exact)\.n([0-9]+)$")


def b5(counts) -> dict:
    """The pass counter's keys of ``counts`` (a recorder's also counts its
    spans)."""
    return {k: v for k, v in counts.items()
            if k.startswith(cuda_elasticity.COUNTER + ".")}


def config(degree, r):
    return {"dim": 3, "degree": degree, "refinements": r, "mu": MU,
            "lam": LAM}


def random_field(shape, seed):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape))


def rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("degree", [2, 3])
def test_apply_against_dense(degree):
    ref = reference.make(config(degree, 2), "cpu")
    x = random_field(ref.shape, 1)
    assert rel(ref.apply(x), dense.make(config(degree, 2), "cpu").apply(x)
               ) <= 1e-13


@pytest.mark.parametrize("degree", [2, 3])
def test_solve_against_dense(degree):
    ref = reference.make(config(degree, 2), "cpu")
    b = random_field(ref.shape, 2)
    want = dense.make(config(degree, 2), "cpu").solve(b)
    got = ref.solve(b)
    assert float((got - want).norm() / want.norm()) <= 1e-11
    assert len(ref.iterations) == 1


@pytest.mark.parametrize("r", [2, 3, 4])
def test_cg_count_flat_under_refinement(r):
    ref = reference.make(config(3, r), "cpu")
    b = random_field(ref.shape, 3)
    x = ref.solve(b)
    assert ref.iterations[0] <= 40
    # the constrained points keep b; the free ones solve A x = b
    res = ref.apply(x) - b
    assert float(res.norm() / b.norm()) <= 1e-9


@pytest.mark.parametrize("variant", ["kron", "auto"])
@pytest.mark.parametrize("degree", [2, 3])
def test_fine_operator_against_reference(variant, degree):
    model = ElasticityMultigrid(3, degree, 2, mu=MU, lam=LAM,
                                dtype=torch.float64, variant=variant,
                                device="cpu")
    op = model.fine_operator
    if variant == "auto":
        assert isinstance(op, cuda_elasticity.CudaElasticityOperator)
    ref = reference.make(config(degree, 2), "cpu")
    x = random_field(ref.shape, 4)
    assert rel(op.apply(x).reshape(ref.shape), ref.apply(x)) <= 1e-12


@pytest.mark.parametrize("variant", ["kron", "auto"])
def test_float64_solve_against_reference(variant):
    model = ElasticityMultigrid(3, 3, 2, mu=MU, lam=LAM, dtype=torch.float64,
                                variant=variant, device="cpu")
    ref = reference.make(config(3, 2), "cpu")
    b = random_field(ref.shape, 5) * ref.mask  # zero on the boundary
    res = cg(model.fine_operator.apply, b, model.preconditioner().apply,
             rtol=1e-12)
    assert res.converged
    want = ref.solve(b)
    assert float((res.x - want).norm() / want.norm()) <= 1e-9


def tiny_model(dtype):
    return ElasticityMultigrid(3, 3, 2, mu=MU, lam=LAM, dtype=dtype,
                               variant="auto", device="cpu")


def test_no_count_outside_tracing():
    model = tiny_model(torch.float32)
    mg = model.preconditioner()
    b = model.rhs()
    with profiling.tracing() as rec:
        pass
    mg.apply(b)
    model.fine_operator.apply(b)
    profiling.count("pmg.elasticity.apply/exact.n4")
    assert not rec.counts and profiling.active() is None
    with profiling.tracing() as rec:
        model.fine_operator.apply(b)
    assert b5(rec.counts) == {"pmg.elasticity.apply/exact.n4": 1}


def level_counts(counts) -> dict:
    """{cells per axis: {"recurrence" or "residual" or mode: passes}}."""
    out = {}
    for key, v in counts.items():
        mode, core, n = KEY.match(key).groups()
        kind = ("residual" if mode.startswith("residual") else
                "recurrence" if mode.startswith("cheb") else mode)
        level = out.setdefault(int(n), {})
        level[kind] = level.get(kind, 0) + v
        level[core] = level.get(core, 0) + v
    return out


def expected(n_levels: int, float32: bool) -> dict:
    apps = elasticity_counts.smoothing_applications()
    smoothing = dict(apps, **({"mxu": apps["recurrence"],
                               "exact": apps["residual"]} if float32 else
                              {"exact": sum(apps.values())}))
    return {1 << k: smoothing for k in range(1, n_levels)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_counts_of_an_eager_vcycle(dtype):
    model = tiny_model(dtype)
    mg = model.preconditioner()
    with profiling.tracing() as rec:
        mg.apply(model.rhs())
    (plan,) = rec.plans
    assert plan.counts == b5(rec.counts) and plan.counts
    assert all(KEY.match(k) for k in plan.counts)
    got = level_counts(plan.counts)
    coarse = got.pop(1)  # Chebyshev as the solver, on the exact apply
    assert set(coarse) == {"apply", "exact"} and coarse["apply"] >= 1
    assert got == expected(len(model.levels), dtype == torch.float32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.requires_cuda
def test_counts_of_a_traced_graph(cuda_device):
    model = ElasticityMultigrid(3, 3, 3, mu=MU, lam=LAM, dtype=torch.float32,
                                variant="auto", device=cuda_device)
    graphed = model.preconditioner()
    b = model.rhs()
    before = dict(cuda_elasticity.LAUNCHES)
    plain = graphed.apply(b)
    launched = {k: v - before.get(k, 0)
                for k, v in cuda_elasticity.LAUNCHES.items()}
    with profiling.tracing() as rec:
        traced = graphed.apply(b)
        for _ in range(3):
            graphed.apply(b)
    torch.cuda.synchronize()
    plan = graphed.span_plan
    # the warm-up's plan and the capture's each hold one V-cycle
    assert len(rec.plans) == 2 and rec.plans[0].counts == plan.counts
    assert b5(rec.counts) == plan.counts + plan.counts
    got = level_counts(plan.counts)
    coarse = got.pop(1)
    assert set(coarse) == {"apply", "exact"}
    assert got == expected(len(model.levels), True)
    # the kernel's own launch counts: warm-up and capture of the untraced
    # graph, the same passes as the traced one's
    per_cycle = {}
    for key, v in plan.counts.items():
        mode, core, _ = KEY.match(key).groups()
        name = mode + ("/mxu" if core == "mxu" else "")
        per_cycle[name] = per_cycle.get(name, 0) + v
    assert {k: v for k, v in launched.items() if v} == {
        k: 2 * v for k, v in per_cycle.items()}
    assert rel(traced.double(), plain.double()) <= 1e-6
