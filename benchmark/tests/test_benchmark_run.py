"""Whole runs on the CPU at a tiny size, past the harness's look for a card:
a sound run is correct, and each fault a training cell can have, and each
fault of the program's own draws and batches, planted in the program's
timed path (``faults.py``), makes it not correct. The command itself refuses
to run without a card. Nothing the benchmark runs imports JAX or the JAX
package, and the reference imports nothing of the program."""

import ast
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import core, faults
from conftest import ROOT


def _run(tiny_root, workload, trace=0):
    return core.run_cell(tiny_root, workload, 2**31 + 101, 1.0 if not trace else 4.0, trace,
                         time.perf_counter(), device="cpu", log=lambda msg: None)


# the end-to-end metrics a run on the CPU reports (the device's time per
# step has no trace to read here), and the per-layer ones a traced run does
# (only the host-clock readers and those of the program's own spans have
# something to read; the restart step opens none of the latter)
_HOST_SPANS = {"step.host_ms", "elbo.fwd_host_ms", "elbo.bwd_host_ms", "step.syncs",
               "fit_loop.device_wait_ms"}
CPU_METRICS = {
    "cosmos-tiny-fit": ({"setup_s"},
                        {"fit_loop.steps_per_s"} | {f"{m}.busy" for m in _HOST_SPANS}),
    "crosstalk-tiny-fit": ({"fit_steps_per_s", "setup_s"},
                           {"fit_loop.checkpoint_ms", "fit_loop.checkpoint_write_ms"}
                           | _HOST_SPANS),
    "hmm-tiny-fit": ({"setup_s"}, {"fit_loop.steps_per_s", "elbo.chain_host_ms.busy"}
                     | {f"{m}.busy" for m in _HOST_SPANS}),
    "cosmos-tiny-restarts-r4": ({"setup_s"}, {"fit_loop.steps_per_s"}),
}
CELLS = ["cosmos-tiny-fit", "crosstalk-tiny-fit", "cosmos-tiny-restarts-r4"]


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(tiny_root, workload):
    r = _run(tiny_root, workload)
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == CPU_METRICS[workload][0]
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_host_spans(tiny_root, workload):
    r = _run(tiny_root, workload, trace=1)
    assert r["correct"] is True
    assert set(r["metrics"]) == CPU_METRICS[workload][1]


@pytest.mark.parametrize("workload,method", [("cosmos-tiny-fit", "_sparse_step"),
                                             ("cosmos-tiny-restarts-r4", "_restart_step")])
def test_a_reader_listing_step_reads_the_entrys_step(tiny_root, tmp_path, workload, method):
    """A per-layer reader that lists its own ``step`` (``_sparse_step``)
    reads the step that the cell's entry drives: the traced window's every
    step, and the span the run installs is the entry's."""
    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    (root / "benchmark/metrics/step.calls.py").write_text(
        'SPANS = {"step": {"method": "_sparse_step"}}\n\n\n'
        'def read(view):\n    return float(len(view.host["step"]))\n')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "step.calls", "unit": "calls", "better": "lower",
                               "source": "host_clock", "layer": "step",
                               "moves": "fit_device_ms_per_step", "workloads": [workload]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = core.Cell(root, workload)
    assert core.span_specs(cell, cell.metrics("per_layer"))["step"] == {"method": method}
    r = _run(root, workload, trace=1)
    assert r["correct"] is True
    assert r["metrics"]["step.calls"]["value"] == r["attempted"] > 0


class _Trace:
    n_steps, busy_s, window_s = 20, 0.09, 0.8


class _View:
    trace = _Trace()


def test_device_time_per_step_reads_the_busy_union():
    """The end-to-end device time per step is the busy union over the
    profiled steps, and reads nothing without a trace; a cell's untraced
    run installs the profiled stretch for it."""
    reader = core.load_module(ROOT / "benchmark/metrics/fit_device_ms_per_step.py")
    assert reader.read(_View()) == pytest.approx(4.5)
    assert reader.read(None) is None
    cell = core.Cell(ROOT, "cosmos-elife-fit")
    traced = [m["name"] for m in cell.metrics("end_to_end") if m["source"] == "device_trace"]
    assert traced == ["fit_device_ms_per_step"]
    assert core.span_specs(cell, [{"name": traced[0]}])["step"] == {"method": "_sparse_step"}


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_in_the_timed_path_is_not_correct(tiny_root, workload, fault):
    with faults.FAULTS[fault]():
        assert _run(tiny_root, workload)["correct"] is False


def test_command_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "cosmos-elife-fit", "--seed",
         str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def _spans_modules(path):
    """Module names a metric file's spans look up."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and "." in node.value:
            yield node.value.split(".")[0]


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_a_reference_apart_from_the_program(path):
    names = set(_imports(path))
    if path.parent.name in ("metrics", "entries"):
        names |= set(_spans_modules(path))
    assert not names & {"jax", "jaxlib", "flax", "tapqir_tpu"}, names
    apart = {"reference", "counts"}
    if apart & set(path.relative_to(ROOT / "benchmark").parts) or path.name in (
            "compare.py", "simulate.py"):
        assert "tapqir_tpu_torch" not in set(_imports(path))


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert "tapqir_tpu" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tapqir_tpu_torch_like", sys)
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert core.forbidden_modules() == ["jaxlib"]
