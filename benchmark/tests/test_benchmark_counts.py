"""The frozen operation and byte count of the likelihood, worked by hand at
a tiny shape, and the per-layer readers on a trace made up for the test."""

import json

import pytest

from benchmark import core, tracing
from conftest import ROOT


def count():
    return core.load_module(ROOT / "benchmark/counts/offset_gamma.py")


def test_count_by_hand():
    # M=2 configs, nb=3 images of ev=4 pixels, J=5 bins, all pairs live:
    # pairs 60; per pair 3 + 6*2 = 15 -> 900; per (pixel, config) 24 pairs
    # x (9 forward + 3 backward) = 288
    ops, nbytes = count().forward_backward(2, 3, 4, 5, 1.0)
    assert ops == 900 + 288
    # read images 12 and concentrations 24, write sums 6, read their
    # gradients 6, write the concentrations' gradients 24: 72 floats
    assert nbytes == 4 * 72
    ops_half, _ = count().forward_backward(2, 3, 4, 5, 0.5)
    assert ops_half == 450 + 288


def test_least_time_takes_the_larger_bound():
    peaks = {"fp32_flops_per_s": 1e3, "bytes_per_s": 1e3}
    assert count().least_seconds(2000, 500, peaks) == 2.0
    assert count().least_seconds(500, 3000, peaks) == 3.0


def test_cell_shapes():
    cos = core.Cell(ROOT, "cosmos-elife-fit")
    xt = core.Cell(ROOT, "crosstalk-elife-fit")
    assert cos.reference.likelihood_shape(cos.cfg) == (4, 5120)
    assert xt.reference.likelihood_shape(xt.cfg) == (16, 10240)


def _trace(tmp_path):
    """Two steps of 10 us; each launches a 2 us kernel in the ELBO forward,
    a 3 us one in the backward and a 0.5 us copy in the update."""
    ev = []
    corr = [0]

    def kernel(name, host_ts, dev_ts, dur, cat="kernel"):
        corr[0] += 1
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": host_ts,
                   "dur": 0.5, "args": {"correlation": corr[0]}})
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": dev_ts, "dur": dur,
                   "args": {"correlation": corr[0]}})

    for s, t0 in enumerate((100.0, 110.0)):
        ev.append({"ph": "X", "cat": "user_annotation", "name": "span::step", "ts": t0, "dur": 10})
        ev.append({"ph": "X", "cat": "user_annotation", "name": "span::elbo_fwd", "ts": t0 + 1,
                   "dur": 3})
        ev.append({"ph": "X", "cat": "user_annotation", "name": "span::elbo_bwd", "ts": t0 + 5,
                   "dur": 3})
        kernel("fwd", t0 + 2, t0 + 3, 2)
        kernel("bwd", t0 + 6, t0 + 6.5, 3)
        kernel("copy", t0 + 9, t0 + 9.5, 0.5, cat="gpu_memcpy")
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return tracing.Trace(path)


def test_trace_attribution(tmp_path):
    tr = _trace(tmp_path)
    assert tr.n_steps == 2
    assert len(tr.in_span("step")) == 6
    assert tr.seconds(tr.in_span("elbo_fwd")) == pytest.approx(4e-6)
    assert tr.seconds(tr.in_span("elbo_bwd")) == pytest.approx(6e-6)
    # the stretch runs from the first step's start to the last event's end
    assert tr.window_s == pytest.approx(20e-6)
    assert tr.busy_s == pytest.approx(11e-6)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["bwd", pytest.approx(6e-6)]
    assert sum(v for _, v in bd["idle_gaps"]) == pytest.approx(9e-6)


def test_readers_on_the_made_up_trace(tmp_path):
    cell = core.Cell(ROOT, "cosmos-elife-fit")
    tr = _trace(tmp_path)

    class View:
        trace = tr
        host = {"checkpoint": [0.1, 0.3]}

    v = View()
    read = {m: cell.metric_reader(m).read for m in
            ("step.launches", "step.update_device_ms", "elbo.fwd_device_ms",
             "elbo.bwd_device_ms", "device.idle_share", "fit_loop.checkpoint_ms")}
    assert read["step.launches"](v) == 3
    assert read["elbo.fwd_device_ms"](v) == pytest.approx(2e-3)
    assert read["elbo.bwd_device_ms"](v) == pytest.approx(3e-3)
    assert read["step.update_device_ms"](v) == pytest.approx(0.5e-3)
    assert read["device.idle_share"](v) == pytest.approx(45.0)
    assert read["fit_loop.checkpoint_ms"](v) == pytest.approx(200.0)
    View.trace = None
    assert all(read[m](v) is None for m in read if m != "fit_loop.checkpoint_ms")
