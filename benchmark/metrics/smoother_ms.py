"""Device ms per V-cycle of the smoothing: the sum over levels of the
program's device spans ``vcycle.L<l>.pre`` (every pre-smoothing step with
the residual) and ``vcycle.L<l>.post``, from ``GraphedVCycle.span_ms()`` of
the traced graph's replays in the program-span pass
(``pmgbench/program_trace.py``)."""

from pmgbench import program_trace


def read(run):
    t = program_trace.of(run)
    if t is None:
        return None
    return sum(v[0] for k, v in t.span_ms.items()
               if k.startswith("vcycle.L") and k.endswith((".pre", ".post")))
