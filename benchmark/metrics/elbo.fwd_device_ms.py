"""elbo.fwd_device_ms: device milliseconds per step launched inside the
model's ``elbo_from_windows`` (the guide's draws, the discrete tables and
the likelihood forward)."""

SPANS = {"elbo_fwd": {"method": "elbo_from_windows"}}


def read(view):
    tr = view.trace
    if tr is None or not tr.n_steps or not tr.spans.get("elbo_fwd"):
        return None
    return 1e3 * tr.seconds(tr.in_span("elbo_fwd")) / tr.n_steps
