"""``GraphedVCycle.capture_seconds``: the eager warm-up V-cycle plus the
capture and instantiation of the V-cycle's CUDA graph; nothing where the
preconditioner is no graph."""


def read(run):
    return run.graph_capture_s
