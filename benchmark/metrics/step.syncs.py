"""step.syncs: host-device syncs per step, counted by the program's tracing
(``torch.cuda.set_sync_debug_mode("warn")``) in its ``step.*`` and
``elbo.*`` spans, outside the profiled stretch. A sync inside the step
makes the host wait for the card and breaks a CUDA graph's capture."""

from pathlib import Path

from benchmark import core

_spans = core.load_module(Path(__file__).with_name("program_spans.py"))
SPANS = {}


def read(view):
    return _spans.syncs_per_step(("step.", "elbo."))
