"""The card's idle share inside the graphed V-cycle: over each replay of
the traced graph in the program-span pass, from its first marker to its
last, 1 - the union of the kernel, copy and set intervals other than the
markers, over the replays' summed length (``pmgbench/program_trace.py``)."""

from pmgbench import program_trace


def read(run):
    t = program_trace.of(run)
    if t is None or not t.replay_s:
        return None
    return t.replay_idle_share
