"""The top level's smoothing against its roofline, in %: the least time
of the operator applications that one V-cycle's pre- and post-smoothing
make on the finest level, counted from the algorithm
(``elasticity_counts.smoothing_applications``: Chebyshev degree 5, V(2,2),
20 applications) at the bound of one application
(``elasticity_counts.apply_bound_s``, in the V-cycle's dtype), over the
device ms per V-cycle of the program's spans ``vcycle.L<top>.pre`` and
``vcycle.L<top>.post`` (``GraphedVCycle.span_ms()`` of the program-span
pass, ``pmgbench/program_trace.py``)."""

from pmgbench import elasticity_counts, program_trace


def read(run):
    t = program_trace.of(run)
    if t is None:
        return None
    c = run.cell.config
    top = c["levels"] - 1
    spans = [t.span_ms.get(f"vcycle.L{top}.{phase}") for phase in
             ("pre", "post")]
    if None in spans:
        return None
    dtype = run.cell.model_spec()["kwargs"]["dtype"]
    bound, _ = elasticity_counts.apply_bound_s(c["dim"], c["degree"],
                                               c["refinements"], dtype)
    applications = sum(elasticity_counts.smoothing_applications().values())
    return 100 * applications * bound / (sum(s[0] for s in spans) / 1e3)
