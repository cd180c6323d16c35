"""fit_device_ms_per_step: the device's busy milliseconds per SVI step: the
union of device activity (kernels, copies, fills) over the profiled
stretch, from the first profiled step's start to the end of the last event
it launched, over the stretch's steps. An end-to-end metric, read in the
untraced run, whose window holds the profiled stretch for it."""

SPANS = {}


def read(view):
    tr = view.trace if view is not None else None
    if tr is None or not tr.n_steps:
        return None
    return 1e3 * tr.busy_s / tr.n_steps
