"""Fine DoFs times V-cycles over the summed device time of every
preconditioner call of the traced run's window, each timed by CUDA events
recorded before and after the call: the reference bench's
``vcycle_dof_throughput`` measured from outside the program."""


def read(run):
    t = run.window.precond_s
    if not t:
        return None
    return run.n_dofs * len(t) / sum(t)
