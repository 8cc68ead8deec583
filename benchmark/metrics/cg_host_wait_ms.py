"""Device idle ms per solve while CG reads to the host: the idle gaps of
the program-span pass's window whose start lies inside the program's
``pmg.cg.host_read`` span, outside the V-cycle's replays and before
anything but a replay's first marker (a gap that ends there waits for the
graph's launch), summed, over the window's ``pmg.cg.solve`` spans
(``pmgbench/program_trace.py``)."""

from pmgbench import program_trace


def read(run):
    t = program_trace.of(run)
    if t is None or not t.solves:
        return None
    return 1e3 * t.idle_gaps.get("pmg.cg.host_read", 0.0) / t.solves
