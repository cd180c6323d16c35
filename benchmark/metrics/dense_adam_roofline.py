"""dense_adam_roofline: the dense Adam's least time over its device time,
in percent, per step. The least time is the bytes of one update of every
(R, ...) parameter leaf at the memory peak (``counts/dense_adam.py``; the
leaves' shapes and dtypes from the configuration, through the reference's
``param_leaves``); the device time is that of every event launched inside
``_dense_adam`` as ``tapqir_tpu_torch.models.model`` looks it up, whatever
kernels implement it.

The count is of the whole update, so the time has to be too: a run in
which the profiled steps make fewer calls of that function than steps, or
whose calls launch nothing on the card, raises rather than read a share of
part of the work. A program that replaces the function keeps its name and
its place in that module, or brings a metric of its own."""

SPANS = {"dense_adam": {"function": "_dense_adam",
                        "modules": ["tapqir_tpu_torch.models.model"]}}


def read(view):
    tr = view.trace
    peaks = view.peaks()
    if tr is None or not tr.n_steps or peaks is None:
        return None
    calls = len(tr.spans.get("dense_adam", []))
    events = tr.in_span("dense_adam")
    if calls < tr.n_steps or not events:
        raise RuntimeError(
            f"dense_adam_roofline: {tr.n_steps} profiled steps made {calls} calls of "
            f"_dense_adam as {SPANS['dense_adam']['modules'][0]} looks it up, launching "
            f"{len(events)} device events: the update ran elsewhere")
    cell, problem = view.cell, view.problem
    leaves = cell.reference.param_leaves(cell.cfg, problem["Nt"], problem["F"], problem["C"])
    count = cell.count("dense_adam")
    least = count.least_seconds(count.step_bytes(leaves), peaks)
    return 100.0 * least / (tr.seconds(events) / tr.n_steps)
