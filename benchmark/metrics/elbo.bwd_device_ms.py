"""elbo.bwd_device_ms: device milliseconds per step launched inside the
step's ``torch.autograd.grad`` (the ELBO's backward, run by the autograd
engine's threads while the call waits)."""

SPANS = {"elbo_bwd": {"function": "grad", "modules": ["torch.autograd"]}}


def read(view):
    tr = view.trace
    if tr is None or not tr.n_steps or not tr.spans.get("elbo_bwd"):
        return None
    return 1e3 * tr.seconds(tr.in_span("elbo_bwd")) / tr.n_steps
