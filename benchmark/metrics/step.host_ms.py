"""step.host_ms: host milliseconds per step in the sparse step's own work,
the self time of the program's spans ``step.batch`` (the batch's draw),
``step.gather`` (the parameter and Adam-moment windows), ``step.update``
(the step counts and the Adam arithmetic) and ``step.scatter``, outside
the profiled stretch."""

from pathlib import Path

from benchmark import core

_spans = core.load_module(Path(__file__).with_name("program_spans.py"))
SPANS = {}


def read(view):
    return _spans.ms_per_step(("step.batch", "step.gather", "step.update", "step.scatter"),
                              key="self_ns")
