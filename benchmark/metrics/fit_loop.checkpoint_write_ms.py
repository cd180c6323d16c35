"""fit_loop.checkpoint_write_ms: host milliseconds per checkpoint chunk in
the full write, the program's span ``checkpoint.write`` around
``_write_checkpoint`` (the state's copy to the host, ``np.savez`` and the
rename), the part of ``fit_loop.checkpoint_ms`` that the write takes."""

from pathlib import Path

from benchmark import core

_spans = core.load_module(Path(__file__).with_name("program_spans.py"))
SPANS = {}


def read(view):
    return _spans.ms_per_chunk("checkpoint.write")
