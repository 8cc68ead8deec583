"""CG iterations (``CGResult.iterations``), the mean over the window's
solves."""


def read(run):
    its = run.window.iterations
    return sum(its) / len(its)
