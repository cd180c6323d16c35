"""step.update_device_ms: device milliseconds per step launched inside
``Model._sparse_step`` but outside the ELBO's forward and its backward
(``torch.autograd.grad``): the window gather, the sparse Adam and the
scatter."""

SPANS = {
    "step": {"method": "_sparse_step"},
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
