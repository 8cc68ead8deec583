"""CG iterations of the elasticity cell (``CGResult.iterations``), the mean
over the window's solves, as ``cg_iterations`` reads them: where a coarser
grade of B.5 slows convergence, it shows here first.  Read on the card
only, as the cell's other per-layer metrics are: a CPU run (the harness's
own tests) reads nothing."""


def read(run):
    if run.window.stream.device.type != "cuda":
        return None
    return run.cell.reader("cg_iterations")(run)
