"""device.idle_share: the share of the profiled stretch's wall time in
which no operation ran on the device, in percent (1 - the union of device
activity over the stretch, from the first profiled step's start to the end
of the last event it launched)."""

SPANS = {}


def read(view):
    tr = view.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
