"""offset_gamma_roofline: the likelihood's least time over its device time,
in percent, per step. The least time is the larger of the counted
operations at the float32 peak and the counted bytes at the memory peak
(``counts/offset_gamma.py``, from the cell's shapes and data); the device
time is that of every event launched inside the model's calls of
``offset_gamma_log_prob_summed`` and inside the autograd nodes those calls
leave, whatever kernels implement it.

The count is of the whole likelihood, so the time has to be too: a run in
which the profiled steps make fewer calls of that function than steps, or
whose calls launch nothing on the card, raises rather than read a share of
part of the work (or none). A program that replaces the function keeps
its name and its place in these modules, or brings a metric of its own."""

SPANS = {
    "likelihood_fwd": {"function": "offset_gamma_log_prob_summed",
                       "modules": ["tapqir_tpu_torch.models.cosmos",
                                   "tapqir_tpu_torch.models.crosstalk"]},
    "likelihood_bwd": {"backward_of": "likelihood_fwd"},
}


def read(view):
    tr = view.trace
    peaks = view.peaks()
    if tr is None or not tr.n_steps or peaks is None:
        return None
    calls = len(tr.spans.get("likelihood_fwd", []))
    fwd, bwd = tr.in_span("likelihood_fwd"), tr.in_span("likelihood_bwd")
    if calls < tr.n_steps or not fwd or not bwd:
        mods = ", ".join(SPANS["likelihood_fwd"]["modules"])
        raise RuntimeError(
            f"offset_gamma_roofline: {tr.n_steps} profiled steps made {calls} calls of "
            f"offset_gamma_log_prob_summed as {mods} look it up, launching {len(fwd)} device "
            f"events and {len(bwd)} in its backward: the likelihood ran elsewhere")
    events = {id(e): e for e in fwd + bwd}
    seconds = tr.seconds(list(events.values())) / tr.n_steps
    ops, nbytes = view.likelihood_count()
    least = view.cell.count("offset_gamma").least_seconds(ops, nbytes, peaks)
    return 100.0 * least / seconds
