"""elbo.chain_host_ms.busy: host milliseconds per step in the program's
span ``elbo.chain`` (the z-chain of cosmos+hmm's ELBO: its scan, marginals
and terms), outside the profiled stretch. Reads nothing where the program
opens no such span."""

from pathlib import Path

from benchmark import core

_spans = core.load_module(Path(__file__).with_name("program_spans.py"))
SPANS = {}


def read(view):
    if _spans.tracing is None or "elbo.chain" not in _spans.tracing.summary():
        return None
    return _spans.ms_per_step(("elbo.chain",))
