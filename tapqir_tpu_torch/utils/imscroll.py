"""Kinetic post-analysis of posterior z samples (counterpart of
tapqir_tpu/utils/imscroll.py), in numpy.

The interval and kinetics conventions of Friedman & Gelles 2015 (Methods
86:27-36), as the JAX package implements them:

* each maximal constant run of a binary trajectory is one interval, coded
  by ``low_or_high``: interior runs keep their state value (0 unbound, 1
  bound); a run censored at the record start is coded ``-state - 2`` (-2 /
  -3); a run censored at the record end - a run spanning the whole record
  included - is coded ``state + 2`` (2 / 3);
* dwell-time collections keep only complete (interior) intervals;
* time to first binding, association and dissociation rates from binary
  trajectories or binding probabilities; bootstrap intervals.

:func:`count_intervals` returns a dict of numpy columns with the names and
order of the JAX package's DataFrame columns, in place of the DataFrame.
"""

import numpy as np

__all__ = [
    "INTERVAL_COLUMNS",
    "count_intervals",
    "bound_dwell_times",
    "unbound_dwell_times",
    "time_to_first_binding",
    "association_rate",
    "dissociation_rate",
    "bootstrap",
    "posterior_estimate",
]

INTERVAL_COLUMNS = ("posterior_sample", "aoi", "start_frame", "stop_frame",
                    "dwell_time", "low_or_high", "z")


def count_intervals(labels) -> dict:
    r"""Run-length encode binding intervals.

    :param labels: (samples, aoi, frames) binary array.
    :return: dict of equal-length numpy columns (:data:`INTERVAL_COLUMNS`),
        one row per maximal constant run, in (sample, aoi, start_frame)
        order.
    """
    z = np.asarray(labels)
    states = z.astype(bool)
    n_samples, n_aois, F = states.shape
    records = states.reshape(n_samples * n_aois, F)

    # a run starts at frame 0 of every record and at every state flip
    run_starts = np.ones_like(records)
    run_starts[:, 1:] = records[:, 1:] != records[:, :-1]
    record, start = np.nonzero(run_starts)

    # runs come out in row-major order, so each run extends to just before
    # the next run of the same record, or to the final frame
    ends_record = np.empty(record.shape, dtype=bool)
    ends_record[:-1] = record[1:] != record[:-1]
    ends_record[-1] = True
    following_start = np.empty_like(start)
    following_start[:-1] = start[1:]
    following_start[-1] = F
    stop = np.where(ends_record, F - 1, following_start - 1)

    state = records[record, start].astype(np.int64)
    # right-censored runs (touching the last frame, whole records included)
    # take state + 2, left-censored runs -state - 2, interior runs the state
    code = np.where(stop == F - 1, state + 2, np.where(start == 0, -state - 2, state))

    sample_idx, aoi_idx = np.divmod(record, n_aois)
    return dict(zip(INTERVAL_COLUMNS, (
        sample_idx, aoi_idx, start, stop, stop + 1 - start, code,
        z.reshape(n_samples * n_aois, F)[record, start],
    )))


def _dwell_times(intervals, state: int) -> np.ndarray:
    """(samples, max_count) zero-padded float32 dwell times of the complete
    intervals in ``state``, one row per posterior sample that has any, in
    sample order."""
    sel = np.asarray(intervals["low_or_high"]) == state
    samples = np.asarray(intervals["posterior_sample"])[sel]
    times = np.asarray(intervals["dwell_time"])[sel]
    order = np.argsort(samples, kind="stable")
    samples, times = samples[order], times[order]
    _, first, counts = np.unique(samples, return_index=True, return_counts=True)
    out = np.zeros((len(counts), int(counts.max())), dtype=np.float32)
    rows = np.repeat(np.arange(len(counts)), counts)
    out[rows, np.arange(len(times)) - np.repeat(first, counts)] = times
    return out


def bound_dwell_times(intervals) -> np.ndarray:
    return _dwell_times(intervals, 1)


def unbound_dwell_times(intervals) -> np.ndarray:
    return _dwell_times(intervals, 0)


def time_to_first_binding(labels) -> np.ndarray:
    r"""Frames elapsed before the first binding event; records with no
    binding are right-censored at F.

    Takes binary z samples or per-frame binding probabilities q(z=1): with
    probabilities the result is the expected time to first binding,
    :math:`\sum_k k\,q_k \prod_{j<k}(1-q_j) + F \prod_j (1-q_j)`, which is
    the first bound frame (or F) for binary input; binary input takes that
    shortcut, without float64 copies of the samples."""
    q = np.asarray(labels)
    F = q.shape[-1]
    if q.dtype == bool or (np.issubdtype(q.dtype, np.integer) and q.size
                           and q.min() >= 0 and q.max() <= 1):
        bound = q.astype(bool, copy=False)
        return np.where(bound.any(-1), bound.argmax(-1), F).astype(np.float64)
    q = q.astype(np.float64)
    never_through = np.cumprod(1.0 - q, axis=-1)  # prod_{j<=k}(1-q_j)
    never_before = np.concatenate(
        [np.ones_like(q[..., :1]), never_through[..., :-1]], axis=-1
    )
    k = np.arange(F, dtype=np.float64)
    return (k * q * never_before).sum(-1) + F * never_through[..., -1]


def association_rate(labels) -> np.ndarray:
    """On-rate of a two-state chain: 0->1 transitions per frame spent
    unbound; binary samples or binding probabilities (expected rate)."""
    q = np.asarray(labels, np.float64)
    events = ((1.0 - q[..., :-1]) * q[..., 1:]).sum((-2, -1))
    unbound_frames = (1.0 - q[..., :-1]).sum((-2, -1))
    return events / unbound_frames


def dissociation_rate(labels) -> np.ndarray:
    """Off-rate of a two-state chain: 1->0 transitions per frame spent
    bound; binary samples or binding probabilities (expected rate)."""
    q = np.asarray(labels, np.float64)
    events = (q[..., :-1] * (1.0 - q[..., 1:])).sum((-2, -1))
    bound_frames = q[..., :-1].sum((-2, -1))
    return events / bound_frames


def bootstrap(samples, estimator, repetitions=1000, probs=0.68, rng=None):
    """Bootstrap interval (central ``probs``) of ``estimator`` over
    resamples of ``samples`` with replacement."""
    samples = np.asarray(samples)
    rng = np.random.default_rng() if rng is None else rng
    n = len(samples)
    estimates = np.fromiter(
        (estimator(samples[rng.integers(0, n, size=n)]) for _ in range(repetitions)),
        dtype=np.float64, count=repetitions,
    )
    lo, hi = np.quantile(estimates, [(1 - probs) / 2, (1 + probs) / 2])
    return lo, hi


def posterior_estimate(sample_fn, estimator, repetitions=1000, probs=0.68):
    """Interval (central ``probs``) of ``estimator`` over draws from a
    posterior sampler ``sample_fn(i)`` -> one sample array."""
    estimates = np.fromiter(
        (estimator(sample_fn(i)) for i in range(repetitions)),
        dtype=np.float64, count=repetitions,
    )
    lo, hi = np.quantile(estimates, [(1 - probs) / 2, (1 + probs) / 2])
    return lo, hi
