"""elbo.scan_device_ms.busy: device milliseconds per step of the z-chain's
prefix scan: every event launched inside ``cumulative_logmatmulexp`` as
``tapqir_tpu_torch.models.hmm`` looks it up, and inside the autograd nodes
those calls leave (the scan's backward). Reads nothing in a model that
makes no such call."""

SPANS = {
    "step": {"method": "_sparse_step"},
    "scan_fwd": {"function": "cumulative_logmatmulexp",
                 "modules": ["tapqir_tpu_torch.models.hmm"]},
    "scan_bwd": {"backward_of": "scan_fwd"},
}


def scan_events(view):
    """The scan's device events of the profiled stretch (forward and
    backward, each once), or None where the trace holds no scan call."""
    tr = view.trace
    if tr is None or not tr.n_steps or not tr.spans.get("scan_fwd"):
        return None
    return list({id(e): e for e in tr.in_span("scan_fwd") + tr.in_span("scan_bwd")}.values())


def read(view):
    events = scan_events(view)
    if events is None:
        return None
    return 1e3 * view.trace.seconds(events) / view.trace.n_steps
