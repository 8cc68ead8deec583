"""1 - the union of the card's kernel, copy and set intervals over the
traced window's wall time (``torch.profiler``, the traced solves after the
window)."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    return 1 - t.busy_s / t.window_s
