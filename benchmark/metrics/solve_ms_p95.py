"""The nearest-rank 95th percentile of every solve's wall time in the
window (``cg`` called to its return and the device synchronised; the
right-hand side's assembly before it is not in the timer), in ms: the
smallest time with at least 95% of the solves at or under it."""

import math


def read(run):
    s = sorted(run.window.solve_s)
    return 1e3 * s[max(0, math.ceil(0.95 * len(s)) - 1)]
