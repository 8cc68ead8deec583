"""The elasticity operator's share of its roofline, in %: the least time one
fine-level application of B.5's operator could take
(``pmgbench/elasticity_counts.py``: the larger of the dim-component
vector's bytes at the HBM rate and the sum-factorised FMAs of vector
``FEEvaluation`` at the peak of the solve's dtype) over the mean device
time of the kernels and copies launched inside the benchmark's
``cg.operator`` span of the traced solves: ``fine_apply_roofline`` with
the elasticity count."""

from pmgbench import elasticity_counts

SPAN = "cg.operator"


def read(run):
    t = run.trace
    if t is None or not t.span_count.get(SPAN) or not t.span_device_s[SPAN]:
        return None
    c = run.cell.config
    bound, _ = elasticity_counts.apply_bound_s(c["dim"], c["degree"],
                                               c["refinements"],
                                               run.cell.traffic["cg_dtype"])
    return 100 * bound / (t.span_device_s[SPAN] / t.span_count[SPAN])
