"""Device ms per V-cycle of the coarsest level's solve, the program's
device span ``vcycle.coarse``, from ``GraphedVCycle.span_ms()`` in the
program-span pass (``pmgbench/program_trace.py``)."""

from pmgbench import program_trace


def read(run):
    t = program_trace.of(run)
    if t is None or "vcycle.coarse" not in t.span_ms:
        return None
    return t.span_ms["vcycle.coarse"][0]
