"""fit_loop.checkpoint_ms: host milliseconds per checkpoint chunk spent in
``Model.save_checkpoint`` (the finite check and its wait for the card, the
rolling series, the metrics log and the full write when it is due), over
every chunk of the traced window."""

SPANS = {"checkpoint": {"method": "save_checkpoint"}}


def read(view):
    calls = view.host.get("checkpoint", [])
    if not calls:
        return None
    return 1e3 * sum(calls) / len(calls)
