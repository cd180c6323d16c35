"""step_mfu.busy: the whole step's counted float32 operations (the
likelihood's forward and backward, ``counts/offset_gamma.py``; the rest of
the step is not counted) over the device's busy time per step (as
``fit_device_ms_per_step`` reads it, in the traced run), over the card's
float32 peak, in percent."""

SPANS = {}


def read(view):
    tr = view.trace
    peaks = view.peaks()
    if tr is None or not tr.n_steps or tr.busy_s <= 0 or peaks is None:
        return None
    ops, _ = view.likelihood_count()
    return 100.0 * ops * tr.n_steps / tr.busy_s / peaks["fp32_flops_per_s"]
