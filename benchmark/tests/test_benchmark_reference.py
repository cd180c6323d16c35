"""The plain reference against the port's CPU path, the frozen simulator
against the port's, and the comparison against lower precisions and
faults, at a tiny size."""

import json
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare, core, simulate


def _program_state(cell, data, seed, device="cpu"):
    with tempfile.TemporaryDirectory() as tmp:
        run = cell.entry.Run(cell, data, seed, Path(tmp), device)
        run.build()
        return run.checked_steps()


def _steps(cell, seed, device="cpu"):
    """The cell's data, the program's checked steps and the reference's
    inputs from them."""
    data, problem = core.make_problem(cell, seed, device)
    prog = _program_state(cell, data, seed, device)
    return problem, prog, core.make_steps(data, prog)


def _readings(cell, prog, ref):
    return compare.readings(prog, ref, *compare.batch_sizes(cell.cfg))


def _cell(tiny_root, model, dtype="float32"):
    cell = core.Cell(tiny_root, f"{model}-tiny-fit")
    cell.cfg = json.loads(json.dumps(cell.cfg))
    cell.cfg["fit"]["dtype"] = dtype
    return cell


@pytest.mark.parametrize("model", ["cosmos", "crosstalk"])
def test_reference_agrees_with_the_port_in_float64(tiny_root, model):
    """The port's float64 CPU path and the reference in float64 take the
    same three steps: the first loss and the first gradients agree to
    rounding. The later losses and the change do to the port's float32 bias
    correction of the per-row step counts (kept from the JAX package), on
    the rows a later step draws again: 1 - 0.999 in float32 is 4.7e-5 off,
    2.3e-5 in a row's first step."""
    cell = _cell(tiny_root, model, "float64")
    problem, prog, steps = _steps(cell, 2**31 + 3)
    ref = cell.reference.run_steps(cell.cfg, problem, steps, device="cpu")
    r = _readings(cell, prog, ref)
    first = abs(prog["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    assert first < 1e-11 and r["grad_gap"] < 1e-8
    # later steps revisit rows that the float32 bias correction moved
    assert r["loss_gap"] < 1e-7 and r["change_gap"] < 1e-4


@pytest.mark.parametrize("model", ["cosmos", "crosstalk"])
def test_sound_float32_port_is_within_the_limits(tiny_root, model):
    cell = _cell(tiny_root, model)
    problem, prog, steps = _steps(cell, 77)
    ref = cell.reference.run_steps(cell.cfg, problem, steps, device="cpu")
    r = _readings(cell, prog, ref)
    assert all(r[k] <= cell.limits[k] for k in compare.NUMBERS), r


@pytest.mark.parametrize("model", ["cosmos", "crosstalk"])
@pytest.mark.parametrize("side", [{"local": "bfloat16", "glob": "float32"},
                                  {"fault": "half_batch"}, {"fault": "frozen"}],
                         ids=["bfloat16", "half_batch", "frozen"])
def test_lower_precision_and_faults_fail(tiny_root, model, side):
    """The reference in the program's place at a lower precision than the
    configuration states, or with a fault planted, fails a limit."""
    cell = _cell(tiny_root, model)
    problem, _, steps = _steps(cell, 5)
    ref = cell.reference.run_steps(cell.cfg, problem, steps, device="cpu")
    other = cell.reference.run_steps(cell.cfg, problem, steps, device="cpu", **side)
    r = _readings(cell, other, ref)
    assert any(r[k] > cell.limits[k] for k in compare.NUMBERS), r


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["cosmos", "crosstalk"])
def test_control_fails_on_the_card(tiny_root, model, cuda_device):
    """The configuration's control (TF32 locals, float32 globals: one step
    below float32 with TF32 off, and float64) fails a limit on the card at
    the tiny size too."""
    cell = _cell(tiny_root, model)
    c = cell.cfg["control"]
    fails = 0
    for seed in (11, 12, 13):
        problem, _, steps = _steps(cell, seed, cuda_device)
        ref = cell.reference.run_steps(cell.cfg, problem, steps, device=cuda_device)
        ctl = cell.reference.run_steps(cell.cfg, problem, steps, device=cuda_device,
                                       local=c["local"], glob=c["global"])
        r = _readings(cell, ctl, ref)
        fails += any(r[k] > cell.limits[k] for k in compare.NUMBERS)
    assert fails == 3


def test_frozen_simulator_is_the_ports():
    """The benchmark's copy draws the port's arrays from the same seed."""
    from tapqir_tpu_torch.utils.simulate import simulate as port_simulate

    truth = json.loads((core.HERE / "configs/crosstalk-elife.json").read_text())["truth"]
    for params in (truth, {k: v for k, v in truth.items() if k != "alpha"}):
        C = 2 if "alpha" in params else 1
        ours = simulate.simulate(6, 5, C, 14, 123, params, 2, "cpu")
        port = port_simulate("cosmos", N=6, F=5, C=C, P=14, seed=123, params=params,
                             device="cpu")
        np.testing.assert_array_equal(ours[0].numpy(), port.images)
        np.testing.assert_array_equal(ours[1].numpy(), port.is_ontarget)


def test_checked_steps_read_back_the_programs_own_batches_and_draws(tiny_root):
    """The checked steps take the window's route: the program draws its
    batches (rows distinct, sorted frames distinct) and its draws itself,
    the same again from the same seed and others from another seed; the
    reference reads them back in the program's packing order."""
    cell = core.Cell(tiny_root, "cosmos-tiny-fit")
    problem, a, steps = _steps(cell, 2**31 + 9)
    _, b, _ = _steps(cell, 2**31 + 9)
    _, c, _ = _steps(cell, 2**31 + 10)
    assert len(a["batches"]) == len(a["draws"]) == cell.traffic["checked_steps"]
    for (ndx, fidx), (ndx2, fidx2), d, d2 in zip(a["batches"], b["batches"], a["draws"],
                                                 b["draws"]):
        assert len(set(ndx.tolist())) == len(ndx) == 4 and len(fidx) == 8
        assert np.all(np.diff(fidx) > 0)
        np.testing.assert_array_equal(ndx, ndx2)
        np.testing.assert_array_equal(d, d2)
        assert np.all(d > 0)
    assert not np.array_equal(a["draws"][0], c["draws"][0])
    spec = cell.reference.Spec(cell.cfg, problem["Nt"], problem["F"], problem["C"])
    glob, loc = spec.unpack(torch.as_tensor(steps[0]["packed"]), 4, 8)
    repacked = spec.pack(glob, loc).numpy()
    np.testing.assert_array_equal(repacked, steps[0]["packed"])
