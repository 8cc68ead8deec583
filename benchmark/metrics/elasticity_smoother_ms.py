"""Device ms per V-cycle of the elasticity V-cycle's smoothing: the sum over
levels of the program's device spans ``vcycle.L<l>.pre`` and
``vcycle.L<l>.post``, read as ``smoother_ms`` reads them for the Poisson
cells."""


def read(run):
    return run.cell.reader("smoother_ms")(run)
