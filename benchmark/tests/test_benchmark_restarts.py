"""The restarts cell (``fit -R 4``) at a tiny size on the CPU: the port's
``fit_restarts`` against the plain reference (``reference/cosmos_restarts.py``)
in float64, a reference without the dense Adam's decay caught, the
reference's lower precisions and faults not correct, and the dense Adam's
count and reader.

Tolerances of the float64 comparison: both sides sum the same float64 terms
in other orders (the program every chain's window in one pass, the
reference one chain and one AOI row at a time) and take the same Adam
arithmetic, the bias corrections in float64 on both; the losses agree to a
few ulps (measured 2.7e-16 relative) and the moments and changes of each
leaf to ~1e-14 of the leaf's largest (Adam divides by the root of nu, which
amplifies the rounding of elements whose gradient is near nought). The
limits, 1e-12 for the losses and 1e-9 for the moments and changes, leave a
hundredfold room and lie far below what a step without the dense decay
moves: every element that one step's window touched and the next step's
does not moves by ~lr there, O(1) of the leaf's change.
"""

import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, core
from conftest import ROOT

CELL = "cosmos-tiny-restarts-r4"
LOSS_RTOL, LEAF_RTOL = 1e-12, 1e-9


def _cell(root, dtype="float32", chains=None):
    cell = core.Cell(root, CELL)
    cell.cfg = json.loads(json.dumps(cell.cfg))
    cell.cfg["fit"]["dtype"] = dtype
    if chains is not None:
        cell.cfg["restarts"]["num_restarts"] = chains
    return cell


def _program(cell, data, seed):
    with tempfile.TemporaryDirectory() as tmp:
        run = cell.entry.Run(cell, data, seed, Path(tmp), "cpu")
        run.build()
        return run.checked_steps()


def _steps(cell, seed):
    data, problem = core.make_problem(cell, seed, "cpu")
    prog = _program(cell, data, seed)
    return data, problem, prog, core.make_steps(data, prog)


def _leaf_gap(prog, ref):
    """The worst leaf's largest elementwise gap over its largest reference
    magnitude."""
    gaps = {}
    for k, r in ref.items():
        p = np.asarray(prog[k]).reshape(r.shape)
        gaps[k] = float(np.abs(p - r).max() / max(np.abs(r).max(), 1e-300))
    return max(gaps.values())


def _change(state):
    return {k: state["p_end"][k] - state["p0"][k] for k in state["p0"]}


def test_reference_agrees_with_the_port_in_float64(tiny_root):
    """Through the harness's entry: the program draws each chain's batch
    and draws, and every number of the check reads rounding."""
    cell = _cell(tiny_root, "float64")
    _, problem, prog, steps = _steps(cell, 2**31 + 3)
    assert len(steps) == 4 * cell.traffic["checked_steps"]
    ref = cell.reference.run_steps(cell.cfg, problem, steps, device="cpu")
    r = compare.readings(prog, ref, *compare.batch_sizes(cell.cfg))
    assert r["loss_gap"] < LOSS_RTOL and r["grad_gap"] < LEAF_RTOL
    assert r["change_gap"] < LEAF_RTOL and r["batch_size_gap"] == 0


@pytest.fixture(scope="module")
def given(tiny_root):
    """The port's ``fit_restarts`` at R = 3 in float64 from the model's
    init on given ``batches=`` and ``draws=`` (the ones its own route drew
    for the same seed): losses, mu after step 1, and the (R, ...)
    parameters before and after three steps; with the reference's inputs
    for the same steps."""
    from tapqir_tpu_torch.parallel.restarts import fit_restarts, stack_params

    R, seed = 3, 2**31 + 17
    cell = _cell(tiny_root, "float64", chains=R)
    data, problem, drawn, steps = _steps(cell, seed)
    n = len(steps) // R
    batches, draws = [], []
    for s in range(n):
        rows = steps[s * R:(s + 1) * R]
        batches.append((torch.as_tensor(np.stack([st["ndx"] for st in rows])),
                        torch.as_tensor(np.stack([st["fidx"] for st in rows])),
                        len(rows[0]["fidx"])))
        draws.append(torch.as_tensor(np.stack([st["packed"] for st in rows])))
    with tempfile.TemporaryDirectory() as tmp:
        run = cell.entry.Run(cell, data, seed, Path(tmp), "cpu")
        model = run.build()
        params = stack_params(model.params, R)
        p0 = {k: v.numpy().copy() for k, v in params.items()}
        seen = {}
        orig = model._restart_step

        def step(params, mu, nu, *args, **kwargs):
            out = orig(params, mu, nu, *args, **kwargs)
            seen.setdefault("mu1", {k: v.numpy().copy() for k, v in mu.items()})
            return out

        model._restart_step = step
        losses, _ = fit_restarts(model, R, n, params=params, batches=batches, draws=draws)
    port = {"losses": losses, "mu1": seen["mu1"], "p0": p0,
            "p_end": {k: v.numpy() for k, v in params.items()}}
    return cell, problem, steps, drawn, port


def test_port_on_given_batches_and_draws_matches_the_reference(given):
    cell, problem, steps, drawn, port = given
    R = cell.cfg["restarts"]["num_restarts"]
    ref = cell.reference.run_steps(cell.cfg, problem, steps, device="cpu")
    ref_losses = np.asarray(ref["losses"]).reshape(-1, R).T  # step-major -> (R, steps)
    assert port["losses"].shape == ref_losses.shape == (R, 3)
    np.testing.assert_allclose(port["losses"], ref_losses, rtol=LOSS_RTOL, atol=0)
    # the given route takes the same steps as the route that drew them
    np.testing.assert_allclose(port["losses"], np.asarray(drawn["losses"]).reshape(-1, R).T,
                               rtol=LOSS_RTOL, atol=0)
    assert _leaf_gap(port["mu1"], ref["mu1"]) < LEAF_RTOL
    assert _leaf_gap(_change(port), _change(ref)) < LEAF_RTOL


def test_reference_without_the_dense_decay_is_caught(given, monkeypatch):
    """A reference whose Adam moves only the window's elements (the sparse
    step's rule) departs from the port by far more than the tolerance."""
    cell, problem, steps, _, port = given

    def windowed(params, grads, mu, nu, t, lr):
        old = [{k: v.clone() for k, v in tree.items()} for tree in (params, mu, nu)]
        dense(params, grads, mu, nu, t, lr)
        for tree, before in zip((params, mu, nu), old):
            for k, v in tree.items():
                v.copy_(torch.where(grads[k] != 0, v, before[k]))

    dense = cell.reference.dense_adam
    monkeypatch.setattr(cell.reference, "dense_adam", windowed)
    ref = cell.reference.run_steps(cell.cfg, problem, steps, device="cpu")
    assert _leaf_gap(port["mu1"], ref["mu1"]) < LEAF_RTOL  # one step: nothing to decay
    assert _leaf_gap(_change(port), _change(ref)) > 1e3 * LEAF_RTOL


@pytest.mark.parametrize("side", [{"local": "bfloat16", "glob": "float32"},
                                  {"fault": "half_batch"}, {"fault": "frozen"}],
                         ids=["bfloat16", "half_batch", "frozen"])
def test_lower_precision_and_faults_fail(tiny_root, side):
    """The reference in the program's place at a lower precision than the
    configuration states, or with a fault planted, fails a limit."""
    cell = _cell(tiny_root)
    _, problem, _, steps = _steps(cell, 5)
    ref = cell.reference.run_steps(cell.cfg, problem, steps, device="cpu")
    other = cell.reference.run_steps(cell.cfg, problem, steps, device="cpu", **side)
    r = compare.readings(other, ref, *compare.batch_sizes(cell.cfg))
    assert any(r[k] > cell.limits[k] for k in compare.NUMBERS), r


@pytest.mark.cuda
def test_control_fails_on_the_card(tiny_root, cuda_device):
    """The configuration's control (TF32 locals, float32 globals) fails a
    limit on the card at the tiny size too."""
    cell = _cell(tiny_root)
    c = cell.cfg["control"]
    fails = 0
    for seed in (11, 12, 13):
        data, problem = core.make_problem(cell, seed, cuda_device)
        with tempfile.TemporaryDirectory() as tmp:
            run = cell.entry.Run(cell, data, seed, Path(tmp), cuda_device)
            run.build()
            prog = run.checked_steps()
        steps = core.make_steps(data, prog)
        ref = cell.reference.run_steps(cell.cfg, problem, steps, device=cuda_device)
        ctl = cell.reference.run_steps(cell.cfg, problem, steps, device=cuda_device,
                                       local=c["local"], glob=c["global"])
        r = compare.readings(ctl, ref, *compare.batch_sizes(cell.cfg))
        fails += any(r[k] > cell.limits[k] for k in compare.NUMBERS)
    assert fails == 3


def test_dense_adam_count_at_elife_scale():
    """18 per-AOI-frame values x 676,240 AOI-frames x 4 chains, plus the
    per-AOI and global leaves, each read four times and written three, in
    float32."""
    cell = core.Cell(ROOT, "cosmos-elife-restarts-r4")
    leaves = cell.reference.param_leaves(cell.cfg, 856, 790, 1)
    elements = sum(int(np.prod(shape)) for shape, _ in leaves.values())
    assert 18 * 856 * 790 * 4 < elements < 18 * 856 * 790 * 4 + 856 * 4 * 8
    assert {dt for _, dt in leaves.values()} == {"float32"}
    assert cell.count("dense_adam").step_bytes(leaves) == 28 * elements
    assert cell.reference.likelihood_shape(cell.cfg) == (4, 20480)


def _trace(tmp_path, calls):
    """Two steps of 10 us; each launches a 2 us kernel in ``calls`` of its
    ``_dense_adam`` spans and a 3 us one elsewhere."""
    from benchmark import tracing

    ev, corr = [], [0]

    def kernel(host_ts, dev_ts, dur):
        corr[0] += 1
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": host_ts,
                   "dur": 0.2, "args": {"correlation": corr[0]}})
        ev.append({"ph": "X", "cat": "kernel", "name": "k", "ts": dev_ts, "dur": dur,
                   "args": {"correlation": corr[0]}})

    for i, t0 in enumerate((100.0, 110.0)):
        ev.append({"ph": "X", "cat": "user_annotation", "name": "span::step", "ts": t0,
                   "dur": 10})
        if i < calls:
            ev.append({"ph": "X", "cat": "user_annotation", "name": "span::dense_adam",
                       "ts": t0 + 6, "dur": 3})
            kernel(t0 + 6.5, t0 + 7, 2)
        kernel(t0 + 1, t0 + 2, 3)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return tracing.Trace(path)


def test_dense_adam_reader_on_a_made_up_trace(tmp_path):
    cell = core.Cell(ROOT, "cosmos-elife-restarts-r4")
    peaks = json.loads((ROOT / "benchmark/peaks.json").read_text())["NVIDIA H100 80GB HBM3"]

    class View:
        trace = _trace(tmp_path, 2)
        problem = {"Nt": 856, "F": 790, "C": 1}

        def peaks(self):
            return peaks

    View.cell = cell
    read = cell.metric_reader("dense_adam_roofline").read
    nbytes = cell.count("dense_adam").step_bytes(
        cell.reference.param_leaves(cell.cfg, 856, 790, 1))
    assert read(View()) == pytest.approx(100.0 * nbytes / peaks["bytes_per_s"] / 2e-6)
    View.trace = _trace(tmp_path, 1)  # a step whose update ran elsewhere
    with pytest.raises(RuntimeError, match="1 calls of _dense_adam"):
        read(View())
    View.trace = None
    assert read(View()) is None
