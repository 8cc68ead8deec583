"""Fine DoFs times the solves the window completed, over the window's
seconds: all the work over all the time, right-hand sides included."""


def read(run):
    w = run.window
    return run.n_dofs * len(w.solve_s) / w.seconds
