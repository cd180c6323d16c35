"""step.launches: device events (kernels, copies, fills) launched inside
the entry's step (``Model._sparse_step`` in the fit, ``Model._restart_step``
in the restarts) per step, in the profiled stretch."""

SPANS = {}


def read(view):
    tr = view.trace
    if tr is None or not tr.n_steps:
        return None
    return len(tr.in_span("step")) / tr.n_steps
