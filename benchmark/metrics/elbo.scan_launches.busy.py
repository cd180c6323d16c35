"""elbo.scan_launches.busy: device events (kernels, copies, fills) per step
launched inside the z-chain's prefix scan, forward and backward: the
events that ``elbo.scan_device_ms.busy.py`` times, counted."""

from pathlib import Path

from benchmark import core

_base = core.load_module(Path(__file__).with_name("elbo.scan_device_ms.busy.py"))
SPANS = _base.SPANS


def read(view):
    events = _base.scan_events(view)
    if events is None:
        return None
    return len(events) / view.trace.n_steps
