"""step.update_device_ms: device milliseconds per step launched inside
the entry's step but outside the ELBO's forward and its backward
(``torch.autograd.grad``): in the fit's ``Model._sparse_step`` the batch's
draw, the window gather and the window Adam; in the restarts'
``Model._restart_step`` the batch's draw, the chain windows' gathers
(their backward is the ELBO's) and the dense Adam."""

SPANS = {
    "elbo_fwd": {"method": "elbo_from_windows"},
    "elbo_bwd": {"function": "grad", "modules": ["torch.autograd"]},
}


def read(view):
    tr = view.trace
    if tr is None or not tr.n_steps:
        return None
    inner = {id(e) for name in ("elbo_fwd", "elbo_bwd") for e in tr.in_span(name)}
    rest = [e for e in tr.in_span("step") if id(e) not in inner]
    return 1e3 * tr.seconds(rest) / tr.n_steps
