"""step_mfu: the whole step's counted float32 operations (the likelihood's
forward and backward, ``counts/offset_gamma.py``; the rest of the step is
not counted) times the window's steps per second outside the profiled
stretch, over the card's float32 peak, in percent."""

SPANS = {}


def read(view):
    peaks = view.peaks()
    rate = view.steps_per_s_unprofiled()
    if peaks is None or rate is None:
        return None
    ops, _ = view.likelihood_count()
    return 100.0 * ops * rate / peaks["fp32_flops_per_s"]
