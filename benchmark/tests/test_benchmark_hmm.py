"""The cosmos+hmm cell at a tiny size on the CPU: a sound run is correct,
the plain reference agrees with the port's float64 path, the reference's
faults are not correct, and the chain's readers read a trace made up for
the test."""

import json
import tempfile
import time
from pathlib import Path

import pytest

from benchmark import compare, core, tracing
from conftest import ROOT, make_tiny_root

CELL = "hmm-tiny-fit"


@pytest.fixture(scope="module")
def hmm_root(tmp_path_factory):
    """The tiny tree with the hmm configuration's ``fbatch`` at its F:
    cosmos+hmm takes every frame, and the check holds a batch to the
    frames the configuration states."""
    root = make_tiny_root(tmp_path_factory.mktemp("tiny-hmm"))
    path = root / "benchmark/configs/hmm-tiny.json"
    cfg = json.loads(path.read_text())
    cfg["fit"]["fbatch"] = cfg["geometry"]["F"]
    path.write_text(json.dumps(cfg))
    return root


def _cell(root, dtype="float32"):
    cell = core.Cell(root, CELL)
    cell.cfg = json.loads(json.dumps(cell.cfg))
    cell.cfg["fit"]["dtype"] = dtype
    return cell


def _steps(cell, seed):
    data, problem = core.make_problem(cell, seed, "cpu")
    with tempfile.TemporaryDirectory() as tmp:
        run = cell.entry.Run(cell, data, seed, Path(tmp), "cpu")
        run.build()
        prog = run.checked_steps()
    return problem, prog, core.make_steps(data, prog)


def test_sound_run_is_correct(hmm_root):
    r = core.run_cell(hmm_root, CELL, 2**31 + 101, 1.0, 0, time.perf_counter(), device="cpu",
                      log=lambda msg: None)
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"setup_s"}  # the device's time has no trace here
    assert r["checks"]["batch_repeat"]["value"] == 1.0  # every step takes every frame


def test_reference_agrees_with_the_port_in_float64(hmm_root):
    """The first loss and gradients agree to rounding; the later losses
    and the change to the port's float32 bias correction of the per-row
    step counts (``test_benchmark_reference.py``)."""
    cell = _cell(hmm_root, "float64")
    problem, prog, steps = _steps(cell, 2**31 + 3)
    ref = cell.reference.run_steps(cell.cfg, problem, steps, device="cpu")
    r = compare.readings(prog, ref, *compare.batch_sizes(cell.cfg))
    first = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    assert first < 1e-11 and r["grad_gap"] < 1e-8
    assert r["loss_gap"] < 1e-7 and r["change_gap"] < 1e-4


@pytest.mark.parametrize("fault", ["half_batch", "frozen"])
def test_reference_faults_are_not_correct(hmm_root, fault):
    cell = _cell(hmm_root)
    problem, _, steps = _steps(cell, 5)
    ref = cell.reference.run_steps(cell.cfg, problem, steps, device="cpu")
    other = cell.reference.run_steps(cell.cfg, problem, steps, device="cpu", fault=fault)
    r = compare.readings(other, ref, *compare.batch_sizes(cell.cfg))
    assert any(r[k] > cell.limits[k] for k in compare.NUMBERS), r


def test_likelihood_shape_takes_every_frame():
    cell = core.Cell(ROOT, "hmm-elife-fit")
    assert cell.reference.likelihood_shape(cell.cfg) == (4, 7900)


def _trace(tmp_path):
    """Two steps of 10 us; each launches a 2 us kernel in the scan's
    forward, two of 1 us in its backward and a 3 us one elsewhere."""
    ev = []
    corr = [0]

    def kernel(host_ts, dev_ts, dur):
        corr[0] += 1
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": host_ts,
                   "dur": 0.2, "args": {"correlation": corr[0]}})
        ev.append({"ph": "X", "cat": "kernel", "name": "k", "ts": dev_ts, "dur": dur,
                   "args": {"correlation": corr[0]}})

    for t0 in (100.0, 110.0):
        for name, start, dur in (("step", 0, 10), ("scan_fwd", 1, 2), ("scan_bwd", 5, 1),
                                 ("scan_bwd", 6.5, 1)):
            ev.append({"ph": "X", "cat": "user_annotation", "name": f"span::{name}",
                       "ts": t0 + start, "dur": dur})
        kernel(t0 + 1.5, t0 + 2, 2)
        kernel(t0 + 5.5, t0 + 6, 1)
        kernel(t0 + 7, t0 + 7.2, 1)
        kernel(t0 + 8.5, t0 + 8.6, 3)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return tracing.Trace(path)


def test_scan_readers_on_a_made_up_trace(tmp_path):
    cell = core.Cell(ROOT, "hmm-elife-fit")

    class View:
        trace = _trace(tmp_path)

    ms = cell.metric_reader("elbo.scan_device_ms.busy").read
    launches = cell.metric_reader("elbo.scan_launches.busy").read
    assert ms(View()) == pytest.approx(4e-3)
    assert launches(View()) == 3
    View.trace.spans.pop("scan_fwd")  # a program with no scan call: nothing to read
    assert ms(View()) is None and launches(View()) is None
    View.trace = None
    assert ms(View()) is None and launches(View()) is None


def test_chain_host_reader_reads_the_programs_span():
    """Host ms per step in the program's ``elbo.chain``; nothing where the
    program opens no such span (the parent of the change that adds it)."""
    from tapqir_tpu_torch import tracing as program

    reader = core.Cell(ROOT, "hmm-elife-fit").metric_reader("elbo.chain_host_ms.busy")
    try:  # loading a reader of the program's spans turns its tracing on
        program.reset()
        program.enable()
        for _ in range(2):
            with program.span("step.batch"):
                pass
        assert reader.read(None) is None
        with program.span("elbo.forward"), program.span("elbo.chain"):
            time.sleep(0.01)
        value = reader.read(None)
        total = program.summary()["elbo.chain"]["total_ns"]
        assert value == pytest.approx(1e-6 * total / 2) and value >= 5.0
    finally:
        program.disable()
        program.reset()
