"""step.launches: device events (kernels, copies, fills) launched inside
``Model._sparse_step`` per step, in the profiled stretch."""

SPANS = {"step": {"method": "_sparse_step"}}


def read(view):
    tr = view.trace
    if tr is None or not tr.n_steps:
        return None
    return len(tr.in_span("step")) / tr.n_steps
