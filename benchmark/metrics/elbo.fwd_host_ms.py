"""elbo.fwd_host_ms: host milliseconds per step in the ELBO's forward, the
program's span ``elbo.forward`` around the sparse step's call of
``elbo_from_windows``, outside the profiled stretch."""

from pathlib import Path

from benchmark import core

_spans = core.load_module(Path(__file__).with_name("program_spans.py"))
SPANS = {}


def read(view):
    return _spans.ms_per_step(("elbo.forward",))
