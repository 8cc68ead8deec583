"""Set-up: from the start of the run's process (the first line of
``run.py``) to the start of the window's first solve.  It holds the imports,
the kernel library's build or load, the model's construction, the V-cycle's
graph capture, the source basis and the warm-up solve."""


def read(run):
    return run.setup_s
