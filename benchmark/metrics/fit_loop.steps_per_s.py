"""fit_loop.steps_per_s: the SVI steps that ``Model.run`` completed in the
window over its wall time (host clock), outside the profiled stretch: the
end-to-end ``fit_steps_per_s`` as a per-layer reading, in the cells where
the host's speed spreads it too widely to hold a bound."""

SPANS = {}


def read(view):
    return view.steps_per_s_unprofiled()
