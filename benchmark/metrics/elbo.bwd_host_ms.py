"""elbo.bwd_host_ms: host milliseconds per step in the ELBO's backward, the
program's span ``elbo.backward`` around the sparse step's
``torch.autograd.grad`` (the main thread waits there while the autograd
thread dispatches the backward's launches), outside the profiled
stretch."""

from pathlib import Path

from benchmark import core

_spans = core.load_module(Path(__file__).with_name("program_spans.py"))
SPANS = {}


def read(view):
    return _spans.ms_per_step(("elbo.backward",))
