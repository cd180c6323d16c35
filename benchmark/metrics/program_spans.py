"""The program's own spans (``tapqir_tpu_torch.tracing``), read by the
per-layer metrics of host milliseconds and syncs per step or per chunk.

Importing this file resets the program's tracing and turns it on. The
harness loads the per-layer readers only in a ``--trace 1`` run, after the
entry's set-up and before the window (``core.run_cell``), so the program's
tracing covers the traced window and stays off in the untraced runs, whose
end-to-end metrics are compared. ``summary()`` leaves out the spans opened
while the profiler recorded its stretch, so the host times here carry none
of its overhead; they are divided by the unprofiled calls of ``step.batch``
(one a step) or of ``fit.checkpoint`` (one a checkpoint chunk). A program
without the tracing module gives nothing to read: every reader returns
None.
"""

try:
    from tapqir_tpu_torch import tracing
except ImportError:
    tracing = None
else:
    tracing.reset()
    tracing.enable()


def _per(unit, value):
    """``value(spans)`` over the unprofiled calls of span ``unit``, or None
    when there are no such calls."""
    spans = tracing.summary() if tracing is not None else {}
    calls = spans.get(unit, {}).get("calls", 0)
    if not calls:
        return None
    return value(spans) / calls


def ms_per_step(names, key="total_ns"):
    """Host ms per step in the spans ``names`` (``key``: their total or
    self ns)."""
    return _per("step.batch", lambda s: 1e-6 * sum(s[n][key] for n in names if n in s))


def ms_per_chunk(name):
    """Host ms per checkpoint chunk in the span ``name``."""
    return _per("fit.checkpoint", lambda s: 1e-6 * s[name]["total_ns"] if name in s else 0.0)


def syncs_per_step(prefixes):
    """Syncs per step counted in the spans whose names start with one of
    ``prefixes``."""
    return _per("step.batch", lambda s: sum(a["syncs"] for n, a in s.items()
                                            if n.startswith(prefixes)))
