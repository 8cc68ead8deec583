"""Run one cell of the benchmark of portable_multigrid_tpu_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with an NVIDIA card.  The cell
(``BENCHMARK.json``'s ``workloads``) names a configuration and a traffic
mix; ``pmgbench/spec.py`` says which files the run reads for them.  Set-up
builds the configuration's model, captures its V-cycle's CUDA graph and
solves the reference program's f = 1 once; the window then solves one
right-hand side after another for ``--seconds`` (``pmgbench/session.py``).
With ``--trace 0`` the result line holds the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, read from CUDA events around
every preconditioner call of the window and from a ``torch.profiler``
trace of a few solves after it.  After the window the plain reference
checks a sample of the solutions (``pmgbench/check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` (solves in the window), ``failed`` (those that missed the
tolerance), ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``, each compared number beside its limit, which the last
lines of standard error repeat.  A cell on S cards runs on cards 0..S-1;
``device`` then gives the fullest card's peak memory as
``memory_peak_bytes``, each card's beside it, and with ``--trace 1`` the
mean of the cards' busy seconds as ``busy_s``, each card's beside it.
Earlier lines give each card, its power limit and clocks, and the seconds
the kernel library took to build or load.  The run refuses to start when a ``PMG_*`` variable is set (every
cell measures the program's default path), and exits non-zero with no
result without a CUDA card, or when the process holds JAX or the JAX
package once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that the run's process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "portable_multigrid_tpu")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules() -> list[str]:
    """Modules of ``sys.modules`` whose top-level name is a forbidden one,
    compared whole (``portable_multigrid_tpu_torch`` is not
    ``portable_multigrid_tpu``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def pmg_variables() -> list[str]:
    return sorted(k for k in os.environ if k.startswith("PMG_"))


def card_line(index: int) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}",
         "--query-gpu=name,power.limit,clocks.sm,clocks.mem,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def execute(args, device, root: Path = ROOT) -> dict:
    """Run the cell of ``root/BENCHMARK.json`` on ``device`` (a cell on S
    > 1 cards on cards 0..S-1 of its type, or on a list of S devices:
    ``session.cell_devices``); returns the result line's object.  The
    command line runs it on the card; the tests call it on the CPU."""
    import torch

    from pmgbench import check, spec
    from pmgbench.session import (RunRecord, Session, card_index, cards,
                                  cell_devices)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(root, args.workload)
    devices = cell_devices(cell, device)
    on = cards(devices)
    if on:
        from portable_multigrid_tpu_torch import _build

        lib = _build.build()
        how = "built" if lib.build_log else "loaded"
        for d in on:
            print(f"card: {card_line(card_index(d))}; kernel library {how} "
                  f"in {lib.build_seconds:.3f} s", flush=True)
    run = Session(cell, devices)
    run.warm_up()
    setup_s = time.perf_counter() - T0
    win = run.window(args.seed, args.seconds, time_precond=bool(args.trace))
    trace = None
    if args.trace:
        trace = run.traced(args.seed, int(cell.traffic["traced_solves"]))
    peaks = [torch.cuda.max_memory_allocated(d) for d in on]
    record = RunRecord(cell=cell, window=win, trace=trace, setup_s=setup_s,
                       hierarchy_build_s=run.hierarchy_build_s,
                       graph_capture_s=run.graph_capture_s(),
                       n_dofs=run.n_dofs)
    run.release()
    correct, shown = check.judge(check.readings(cell, win, run.device),
                                 cell.checks["limits"])
    metrics = {}
    for m in (cell.per_layer if args.trace else cell.end_to_end):
        value = cell.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if on else run.device.type,
                "kind": (torch.cuda.get_device_name(on[0]) if on
                         else run.device.type),
                "count": len(on) or cell.chips,
                "memory_peak_bytes": max(peaks, default=0),
                "memory_peak_bytes_per_card": peaks}
    out = {"correct": correct, "attempted": len(win.solve_s),
           "failed": sum(not c for c in win.converged), "metrics": metrics,
           "device": dev_info}
    if trace is not None:
        dev_info["busy_s"] = trace.busy_s
        dev_info["busy_s_per_card"] = trace.busy_s_per_card
        dev_info["window_s"] = trace.window_s
        out["breakdown"] = {"device_ops": trace.device_ops,
                            "idle_gaps": trace.idle_gaps}
    out["checks"] = shown
    return out


def emit(out: dict) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    pmg = pmg_variables()
    if pmg:
        print(f"refused: {', '.join(pmg)} set; every cell measures the "
              f"program's default path, so no PMG_* variable may be set",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(HERE), str(ROOT)]
    import torch

    from pmgbench import spec

    chips = spec.load_cell(ROOT, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"refused: the cell needs {chips} CUDA card(s), this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = execute(args, "cuda")
    held = forbidden_modules()
    if held:
        print(f"refused: the process holds {', '.join(held)}",
              file=sys.stderr)
        return 3
    emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
