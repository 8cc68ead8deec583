"""Readings that set a cell's limits (``checks/<workload>.json``).

    python3 benchmark/calibrate.py --workload <cell> --seeds <n,n,...> \
        --seconds <s> --control-seeds <n,n,...> --control-seconds <s>

builds the cell's model once, then runs one short window of the cell's own
traffic for each seed of ``--seeds`` and prints the numbers that
``pmgbench/check.py`` compares (the program's readings, of which the
largest is a limit's lower reading).  Then it runs the control on each seed
of ``--control-seeds``: the configuration's plain reference operator,
computed in the precision below the one that the traffic's CG runs in
(bfloat16 below float32, float32 with TF32 off below float64), put in the
place of the program's operator that CG drives, with the program's
V-cycle kept as the preconditioner (the smallest control reading is a
limit's upper reading).  For a cell on S > 1 cards the control gathers the
field's slabs on the first card for each apply, applies the blocked
reference there and hands back the result's slabs, each on its card: slow,
and for calibration only.  The benchmark's own runs never run this.  One
JSON line per window; the last line sums them up.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the nearest precision below the one the traffic's CG runs in
LOWER = {"float32": "bfloat16", "float64": "float32"}


def control_operator(cell, device):
    """The reference operator in the precision below CG's, on ``device``
    (for a cell on S > 1 cards the first)."""
    from pmgbench import slabs
    from pmgbench.session import DTYPES

    dtype = DTYPES[LOWER[cell.traffic["cg_dtype"]]]
    if cell.chips == 1:
        return cell.reference().make(cell.config, device, dtype).apply
    ref = cell.reference().make_blocked(cell.config, device, dtype)
    bounds = slabs.bounds(cell.config, cell.chips)

    def apply(u):
        y = ref.apply(slabs.gather(u.parts, device))
        return type(u)(y[lo:hi].to(t.device)
                       for (lo, hi), t in zip(bounds, u.parts))

    return apply


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control-seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]
    import torch

    from pmgbench import check, spec
    from pmgbench.session import Session

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.load_cell(ROOT, args.workload)
    run = Session(cell, torch.device("cuda"))
    run.warm_up()
    print(json.dumps({"setup_s": time.perf_counter() - T0,
                      "hierarchy_build_s": run.hierarchy_build_s}),
          flush=True)
    seen = {"program": [], "control": []}

    def window(kind, seed, seconds):
        win = run.window(seed, seconds)
        values = check.readings(cell, win, run.device)
        seen[kind].append(values)
        print(json.dumps({"kind": kind, "seed": seed,
                          "solves": len(win.solve_s), **values}), flush=True)

    for seed in map(int, args.seeds.split(",")):
        window("program", seed, args.seconds)
    if args.control_seeds:
        A = control_operator(cell, run.device)
        program = run.callables()
        run.callables = lambda: (A, program[1])
        for seed in map(int, args.control_seeds.split(",")):
            window("control", seed, args.control_seconds)
    summary = {}
    for kind, rows in seen.items():
        if rows:
            pick = max if kind == "program" else min
            summary[kind] = {k: pick(r[k] for r in rows) for k in rows[0]}
    print(json.dumps({"workload": cell.name, "lower": summary.get("program"),
                      "control_least": summary.get("control")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
