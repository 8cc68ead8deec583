"""The model's constructor (hierarchy, operators, smoothers and their
eigenvalue estimates) on the host clock, the device synchronised before
and after."""


def read(run):
    return run.hierarchy_build_s
