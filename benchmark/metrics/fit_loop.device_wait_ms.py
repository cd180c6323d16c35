"""fit_loop.device_wait_ms: host milliseconds per checkpoint chunk that
``Model.run`` waits for the card, the program's span ``fit.device_wait``
around the chunk's one read-back of its losses: how far the card runs
behind the host at a chunk's end."""

from pathlib import Path

from benchmark import core

_spans = core.load_module(Path(__file__).with_name("program_spans.py"))
SPANS = {}


def read(view):
    return _spans.ms_per_chunk("fit.device_wait")
