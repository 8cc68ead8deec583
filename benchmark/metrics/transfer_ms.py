"""Device ms per V-cycle of the grid transfers: the sum over levels of the
program's device spans ``vcycle.L<l>.restrict`` and
``vcycle.L<l>.prolongate`` (prolongate-and-add with the pads and trims
around it), from ``GraphedVCycle.span_ms()`` in the program-span pass
(``pmgbench/program_trace.py``)."""

from pmgbench import program_trace


def read(run):
    t = program_trace.of(run)
    if t is None:
        return None
    return sum(v[0] for k, v in t.span_ms.items()
               if k.startswith("vcycle.L")
               and k.endswith((".restrict", ".prolongate")))
