"""The fine-level operator's share of its roofline, in %: the least time
one application could take (``pmgbench/counts.py``: the larger of its bytes
at the HBM rate and its sum-factorised FMAs at the peak of the solve's
dtype) over the mean device time of the kernels and copies launched inside
the benchmark's ``cg.operator`` span of the traced solves."""

from pmgbench import counts

SPAN = "cg.operator"


def read(run):
    t = run.trace
    if t is None or not t.span_count.get(SPAN) or not t.span_device_s[SPAN]:
        return None
    c = run.cell.config
    bound, _ = counts.fine_apply_bound_s(c["dim"], c["degree"],
                                         c["refinements"],
                                         run.cell.traffic["cg_dtype"])
    return 100 * bound / (t.span_device_s[SPAN] / t.span_count[SPAN])
