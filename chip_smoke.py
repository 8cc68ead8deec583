"""Drive the PyTorch / CUDA port once on an NVIDIA card, end to end.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is allowed to fall back to the CPU):

  1. card and build — the card's name and power limit, then the kernels
     built from ``portable_multigrid_tpu_torch/csrc`` (build time printed);
  2. kernel vs twin — every mode of the three kernels against its plain
     torch twin on the card: p = 1..7 at r = 2 in float32 and float64, and
     p = 4 at the r = 6 fine-level shape; bound 1e-5 (f32) / 1e-12 (f64) on
     the max error relative to the twin's max magnitude;
  3. golden replay — the ``geometric_3d`` rows of
     tests/golden_convergence.json (p = 1..7, r = 1..3) in float64 through
     the kernels: CG counts exact, L2 norms to 1e-10;
  4. main path — GeometricMultigridPoisson(3, 4, 6, float32, "auto") on the
     card, solved to rtol 1e-5: converged in <= 4 iterations, L2 norm within
     1e-4 of 0.0249871331, every tensor on the card, and every kernel's
     launch count raised by that run;
  5. timing — CUDA events, warm-up then the median of 10 runs: the V-cycle,
     the whole solve, and each kernel mode against its twin at r = 6.

The line before the last is a JSON object with one entry per kernel; the
last line is the result object.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from portable_multigrid_tpu_torch import _build
from portable_multigrid_tpu_torch.fem.mesh import HyperCubeMesh
from portable_multigrid_tpu_torch.fem.space import FESpace
from portable_multigrid_tpu_torch.models.poisson import GeometricMultigridPoisson
from portable_multigrid_tpu_torch.ops import cuda_cheb2, cuda_laplace, cuda_transfer
from portable_multigrid_tpu_torch.ops.structured import exact_matmuls
from portable_multigrid_tpu_torch.solvers.cg import cg

GOLDEN_L2_Q4_R6 = 0.0249871331
BOUND = {torch.float32: 1e-5, torch.float64: 1e-12}
KERNELS = {
    "laplace": dict(route="cuda",
                    source="portable_multigrid_tpu_torch/csrc/laplace.cu",
                    replaces="portable_multigrid_tpu/ops/pallas_laplace.py:212",
                    counts=cuda_laplace.LAUNCHES),
    "cheb2": dict(route="cuda",
                  source="portable_multigrid_tpu_torch/csrc/cheb2.cu",
                  replaces="portable_multigrid_tpu/ops/pallas_cheb2.py:168",
                  counts=cuda_cheb2.LAUNCHES),
    "transfer": dict(route="cuda",
                     source="portable_multigrid_tpu_torch/csrc/transfer.cu",
                     replaces="portable_multigrid_tpu/ops/pallas_transfer.py:154",
                     counts=cuda_transfer.LAUNCHES),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def synchronize(device) -> None:
    """Bring a fault in a kernel to light where it happened."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def space(p: int, r: int) -> FESpace:
    return FESpace(HyperCubeMesh(3, r), p)


def masked_trimmed(op, rng, dtype, device) -> torch.Tensor:
    """A random field on the trimmed grid, zero on constrained entries."""
    N = op.n * op.degree
    m = np.ones(N)
    m[0] = 0.0
    v = rng.standard_normal((N, N, N)) * m[:, None, None] * m[None, :, None] * m
    return torch.as_tensor(v, dtype=dtype, device=device)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-300)


# scalars of the comparisons: theta = 1.3, delta = 0.9 recurrence coefficients
SCAL_RES3 = (1.3,)
SCAL_CHEB = (0.59, 1.26)
SCAL_PAIR = (0.59, 1.26, 0.71, 1.52)
SCAL_PAIR_F0 = SCAL_PAIR + (1.3,)


def laplace_cases(op, rng, dtype, device):
    """(mode, kernel call, twin call) for every B.1 mode on random state."""
    u, r, x = (masked_trimmed(op, rng, dtype, device) for _ in range(3))
    args = {"apply": ((), ()), "residual1t": ((r,), ()),
            "residual3t": ((r,), SCAL_RES3), "cheb": ((r, x), SCAL_CHEB),
            "chebl": ((r, x), SCAL_CHEB), "chebd": ((r,), SCAL_CHEB),
            "chebdl": ((r,), SCAL_CHEB)}
    for mode, (ins, scal) in args.items():
        yield (mode, lambda m=mode, i=ins, s=scal: op.run(m, u, i, s),
               lambda m=mode, i=ins, s=scal: cuda_laplace.laplace_twin(
                   op, m, u, i, s))


def cheb2_cases(kern, rng, dtype, device):
    op = kern.op
    d, r, x = (masked_trimmed(op, rng, dtype, device) for _ in range(3))
    args = {"cheb2": (d, r, x, SCAL_PAIR), "cheb2l": (d, r, x, SCAL_PAIR),
            "chebd2": (d, r, None, SCAL_PAIR),
            "chebd2l": (d, r, None, SCAL_PAIR),
            "cheb2f0": (d, None, None, SCAL_PAIR_F0),
            "cheb2f0l": (d, None, None, SCAL_PAIR_F0)}
    for mode, a in args.items():
        yield (mode, lambda m=mode, a=a: kern.steps2(*a, m),
               lambda m=mode, a=a: cuda_cheb2.cheb2_twin(op, *a, m))


def transfer_cases(tr, p, r, rng, dtype, device):
    nf, nc = (2 ** r) * p, (2 ** (r - 1)) * p
    f, dst = (torch.as_tensor(rng.standard_normal((nf,) * 3), dtype=dtype,
                              device=device) for _ in range(2))
    c = torch.as_tensor(rng.standard_normal((nc,) * 3), dtype=dtype,
                        device=device)
    twin = cuda_transfer.transfer_twin
    yield ("restrict", lambda: tr.restrict(f),
           lambda: twin(tr.restrict_.dense, f))
    yield ("prolongate", lambda: tr.prolongate(c),
           lambda: twin(tr.prolong.dense, c))
    yield ("prolongate_and_add", lambda: tr.prolongate_and_add(dst, c),
           lambda: twin(tr.prolong.dense, c, dst))


def level_cases(p, r, dtype, device, seed=0):
    """Every kernel mode at one level shape: (kernel, mode, run, twin)."""
    rng = np.random.default_rng(seed)
    op = cuda_laplace.make_cuda_laplace(space(p, r), dtype, device)
    kern = cuda_cheb2.make_cheb2(op)
    tr = cuda_transfer.make_cuda_h_transfer(space(p, r - 1), space(p, r),
                                            dtype, device)
    for case in laplace_cases(op, rng, dtype, device):
        yield ("laplace",) + case
    for case in cheb2_cases(kern, rng, dtype, device):
        yield ("cheb2",) + case
    for case in transfer_cases(tr, p, r, rng, dtype, device):
        yield ("transfer",) + case


def compare(p, r, dtype, device, results) -> None:
    for name, mode, run, twin in level_cases(p, r, dtype, device):
        got, want = run(), twin()
        synchronize(device)
        worst = 0.0
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if not torch.isfinite(g).all():
                raise RuntimeError(f"{name}/{mode} p={p} r={r}: non-finite")
            err, rel = rel_err(g, w)
            worst = max(worst, rel)
            key = (name, mode, p, r, str(dtype).split(".")[-1])
            results[key] = max(results.get(key, 0.0), err)
        log(f"  {name:9s} {mode:19s} p={p} r={r} {str(dtype)[6:]:8s} "
            f"max rel err {worst:.3e}")
        if not worst <= BOUND[dtype]:
            raise RuntimeError(f"{name}/{mode} p={p} r={r} {dtype}: relative "
                               f"error {worst:.3e} > {BOUND[dtype]:.0e}")


def cuda_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median device time of fn() in ms (CUDA events around each run)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def tensors_of(obj, seen=None):
    """Every tensor reachable from a level object's dataclass fields."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for item in obj:
            yield from tensors_of(item, seen)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from tensors_of(getattr(obj, f.name), seen)


def reset_counts() -> None:
    for k in KERNELS.values():
        for mode in k["counts"]:
            k["counts"][mode] = 0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build() -> str:
    """Phase 1: the card, and the kernels built from the checkout."""
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    lib = _build.build(force=True)
    log(f"phase 1: kernels built in {lib.build_seconds:.1f} s -> {lib.path.name}")
    for line in lib.build_log.splitlines():
        if "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return card


def phase_compare(device, shapes) -> dict:
    """Phase 2: every kernel mode against its twin at (p, r, dtype) shapes;
    returns the max abs errors by (kernel, mode, p, r, dtype)."""
    log("phase 2: kernels vs plain twins")
    errs: dict = {}
    for p, r, dtype in shapes:
        compare(p, r, dtype, device, errs)
    log("phase 2: ok")
    return errs


def phase_golden(device, rows) -> None:
    """Phase 3: golden CG counts and L2 norms in float64 through the kernels."""
    log("phase 3: golden replay, float64, variant auto")
    for row in rows:
        prob = GeometricMultigridPoisson(3, row["degree"], row["refinements"],
                                         torch.float64, "auto", device)
        _, st = prob.solve()
        rel = abs(st.solution_l2_norm / row["l2_norm"] - 1.0)
        log(f"  p={row['degree']} r={row['refinements']}: {st.iterations} "
            f"iterations (golden {row['iterations']}), L2 rel diff {rel:.2e}")
        if (not st.converged or st.iterations != row["iterations"]
                or rel > 1e-10 or st.n_dofs != row["n_dofs"]):
            raise RuntimeError(f"golden row p={row['degree']} "
                               f"r={row['refinements']} does not match")
    log("phase 3: ok")


def phase_main(device, r: int, l2_ref: float, max_iterations: int):
    """Phase 4: the main path, counted from construction to solution."""
    log(f"phase 4: main path GeometricMultigridPoisson(3, 4, {r}, float32, auto)")
    synchronize(device)
    reset_counts()
    t0 = time.perf_counter()
    prob = GeometricMultigridPoisson(3, 4, r, torch.float32, "auto", device)
    synchronize(device)
    t_setup = time.perf_counter() - t0
    x, st = prob.solve(rtol=1e-5, verbose=True)
    synchronize(device)
    per_mode = {name: dict(k["counts"]) for name, k in KERNELS.items()}
    log(f"  setup {t_setup:.2f} s; launches per mode: {per_mode}")
    l2_rel = abs(st.solution_l2_norm / l2_ref - 1.0)
    log(f"  CG iterations {st.iterations}, residual {st.residual_norm:.3e}, "
        f"L2 {st.solution_l2_norm:.10f} (rel diff {l2_rel:.2e})")
    if not (st.converged and st.iterations <= max_iterations):
        raise RuntimeError(f"main path: converged={st.converged} in "
                           f"{st.iterations} iterations")
    if l2_rel > 1e-4:
        raise RuntimeError(f"main path L2 norm off by {l2_rel:.2e}")
    if not torch.isfinite(x).all() or tuple(x.shape) != prob.spaces[-1].grid_shape:
        raise RuntimeError("main path solution not finite or wrong shape")
    stray = [t for lvl in prob.levels for t in tensors_of(lvl)
             if t.device != x.device] + ([x] if x.device != device else [])
    if stray:
        raise RuntimeError(f"{len(stray)} tensors of the solve are off {device}")
    for name, counts in per_mode.items():
        if sum(counts.values()) == 0:
            raise RuntimeError(f"main path never launched the {name} kernel")
    log("phase 4: ok")
    return prob, st, per_mode


def phase_timing(card: str, prob, st, device) -> dict:
    """Phase 5: V-cycle, CG solve and every kernel mode vs its twin."""
    log(f"phase 5: timing on {card} (CUDA events, median of 10)")
    mg = prob.preconditioner()
    rhs = prob.rhs()
    fine_op = prob.levels[-1].op
    n_dofs = prob.spaces[-1].n_dofs
    t_vc = cuda_ms(lambda: mg.apply(rhs))
    log(f"  V-cycle: {t_vc:.3f} ms = {n_dofs / (t_vc * 1e-3):.4e} DoF/s "
        f"({n_dofs} DoFs)")
    t_solve = cuda_ms(lambda: cg(fine_op.apply, rhs, mg.apply, rtol=1e-5),
                      warmup=1)
    log(f"  CG solve to rtol 1e-5 ({st.iterations} iterations): {t_solve:.3f} ms"
        f" = {n_dofs / (t_solve * 1e-3):.4e} DoF/s")
    times = {}
    for name, mode, run, twin in level_cases(4, 6, torch.float32, device):
        t_k, t_t = cuda_ms(run), cuda_ms(twin)
        times[(name, mode)] = (t_k, t_t)
        log(f"  {name:9s} {mode:19s} kernel {t_k:8.3f} ms   twin {t_t:8.3f} ms")
    log("phase 5: ok")
    return times


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the card only")
    device = torch.device("cuda", 0)
    exact_matmuls()
    t_start = time.perf_counter()
    card = phase_build()
    shapes = [(p, 2, dt) for dt in (torch.float32, torch.float64)
              for p in range(1, 8)]
    shapes += [(4, 6, torch.float32), (4, 6, torch.float64)]
    errs = phase_compare(device, shapes)
    with open("tests/golden_convergence.json") as fh:
        phase_golden(device, json.load(fh)["geometric_3d"])
    prob, st, per_mode = phase_main(device, 6, GOLDEN_L2_Q4_R6, 4)
    times = phase_timing(card, prob, st, device)
    log(f"all phases passed in {time.perf_counter() - t_start:.0f} s")
    log(card)  # the card's name and power limit, as nvidia-smi gives them

    kernels = []
    for name, k in KERNELS.items():
        counts = per_mode[name]
        mode = max(counts, key=counts.get)  # the main path's busiest mode
        t_k, t_t = times[(name, mode)]
        err = max(v for key, v in errs.items()
                  if key[0] == name and key[2:] == (4, 6, "float32"))
        kernels.append(dict(name=name, mode=mode, route=k["route"],
                            source=k["source"], replaces=k["replaces"],
                            launches=sum(counts.values()), max_abs_err=err,
                            ms=t_k, plain_ms=t_t))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
