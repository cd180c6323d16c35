"""The fit-level cross-check of the port against the JAX package: the
goldens of tests/golden/gen_crosscheck_jax.py (the JAX simulator's data for
each ``check_*`` of tests/recovery_driver.py and two JAX fits of it), the
bar that scripts/recovery_torch.py applies to the port's fit of that data,
and CPU rehearsals of scripts/recovery_torch.py and
scripts/elife_convergence_torch.py."""

import ast
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from tapqir_tpu.utils import dataset as jax_dataset
from tapqir_tpu.utils.simulate import simulate as jax_simulate
from tapqir_tpu_torch.utils import dataset as port_dataset

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
MODELS = ("cosmos", "cosmos+hmm", "crosstalk")


def _script(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def rec():
    return _script("recovery_torch", ROOT / "scripts" / "recovery_torch.py")


@pytest.fixture(scope="module")
def elife():
    return _script("elife_convergence_torch", ROOT / "scripts" / "elife_convergence_torch.py")


@pytest.fixture(scope="module")
def goldens(rec):
    return {m: rec.load_golden(m) for m in MODELS}


# -- the goldens ----------------------------------------------------------------


@pytest.mark.parametrize("model", MODELS)
def test_golden_dataset_loads_bitwise_in_both_packages(model, rec):
    path = rec.golden_path(model)
    jd, td = jax_dataset.load(path), port_dataset.load(path)
    for name in ("images", "xy", "is_ontarget", "mask", "labels"):
        a, b = getattr(jd, name), getattr(td, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert jd.offset.samples.tobytes() == td.offset.samples.tobytes()
    assert jd.offset.weights.tobytes() == td.offset.weights.tobytes()
    assert (jd.name, jd.channels) == (td.name, td.channels)


def test_cosmos_golden_is_the_jax_simulator(goldens):
    data, _, meta = goldens["cosmos"]
    cfg = meta["config"]
    assert (cfg["N"], cfg["F"], cfg["C"], cfg["P"], cfg["seed"]) == (20, 80, 1, 14, 0)
    sim = jax_simulate("cosmos", N=cfg["N"], F=cfg["F"], C=cfg["C"], P=cfg["P"],
                       seed=cfg["seed"], params=cfg["params"])
    assert sim.images.dtype == data.images.dtype == np.float32
    assert np.array_equal(sim.images, data.images)
    assert np.array_equal(sim.xy, data.xy)
    assert np.array_equal(sim.is_ontarget, data.is_ontarget)
    assert sim.labels.tobytes() == data.labels.tobytes()
    assert np.array_equal(sim.offset.samples, data.offset.samples)
    assert np.array_equal(sim.offset.weights, data.offset.weights)


CHECK_SIZES = {  # model: (N, F, C, steps) of the matching check_*
    "cosmos": (20, 80, 1, 8000),
    "cosmos+hmm": (12, 80, 1, 16000),
    "crosstalk": (12, 40, 2, 8000),
}


@pytest.mark.parametrize("model", MODELS)
def test_golden_fits_are_passing_reference_recoveries(model, goldens, rec):
    """Both JAX fits took the check's budget on its sizes, their intervals
    hold their means, and fit 0 passes the check's bounds (the guide's
    means are the values that ``check_*`` reads)."""
    data, fits, meta = goldens[model]
    N, F, C, steps = CHECK_SIZES[model]
    cfg = meta["config"]
    assert (data.Nt, data.F, data.C) == (N, F, C)
    assert (cfg["N"], cfg["F"], cfg["C"], cfg["iters"]) == (N, F, C, steps)
    assert cfg["params"] == rec.CONFIGS[model][0]
    assert rec.CONFIGS[model][1:] == (N, F, steps)
    for fit in fits.values():
        assert fit["steps"] == steps
        assert -1 <= fit["mcc"] <= 1
        for p in ("gain", "proximity", "lamda"):
            s = fit[p]
            assert np.all(s["LL"] <= s["Mean"]) and np.all(s["Mean"] <= s["UL"]), p
    f0 = fits["fit0"]
    gain = float(f0["gain"]["Mean"])
    assert abs(gain - 7.0) / 7.0 < 0.10
    assert f0["mcc"] > 0.9
    if model == "crosstalk":
        alpha = f0["alpha"]["Mean"]
        assert abs(alpha[0, 0] - 0.85) < 0.05 and abs(alpha[1, 1] - 0.90) < 0.05
        return
    assert 0.15 < float(f0["proximity"]["Mean"]) < 0.28
    assert float(f0["lamda"]["Mean"][0]) < 0.35
    if model == "cosmos":
        assert 0.08 < f0["pi"]["Mean"][0, 1] < 0.28
    else:
        trans = f0["trans"]["Mean"][0]
        assert abs(trans[0, 1] - 0.2) < 0.08 and abs(trans[1, 0] - 0.2) < 0.08


# -- the bar ----------------------------------------------------------------------


def _summary(gain=7.0, proximity=0.2, lamda=(0.15,), mcc=0.95, half=0.05):
    def iv(mean):
        mean = np.asarray(mean, np.float64)
        return {"Mean": mean, "LL": mean - half, "UL": mean + half}

    return {"gain": iv(gain), "proximity": iv(proximity), "lamda": iv(lamda), "mcc": mcc}


def test_bar_passes_on_agreeing_summaries(rec):
    ref = _summary()
    port = _summary(gain=7.04, proximity=0.17, lamda=(0.19,), mcc=0.935)
    res = rec.crosscheck(port, ref, _summary(gain=6.97, mcc=0.96))
    assert res["ok"] and not res["not_decidable"]
    assert set(res["verdicts"].values()) == {"pass"}
    assert len(res["verdicts"]) == 2 * len(rec.BAR_PARAMS) + 1


@pytest.mark.parametrize("component", [
    "gain mean in the reference's interval",
    "the reference's gain mean in its interval",
    "proximity mean in the reference's interval",
    "the reference's proximity mean in its interval",
    "lamda mean in the reference's interval",
    "the reference's lamda mean in its interval",
    "|dMCC| <= 0.02",
])
def test_bar_fails_each_component(component, rec):
    ref = _summary()
    param = component.split()[2] if component.startswith("the") else component.split()[0]
    if param == "|dMCC|":
        port = _summary(mcc=0.95 - 0.021)
    elif component.startswith("the"):
        # the port's interval is narrow and off the reference's mean, but the
        # port's mean still lies in the reference's wide interval
        port = _summary(half=0.05)
        port[param] = {k: np.asarray(v) + 0.04 for k, v in port[param].items()}
        port[param]["LL"] = port[param]["Mean"] - 0.01
    else:
        port = _summary()
        port[param] = {k: np.asarray(v) + 0.06 for k, v in port[param].items()}
        port[param]["LL"] = port[param]["Mean"] - 0.5  # still holds the reference's mean
    res = rec.crosscheck(port, ref, _summary())
    assert not res["ok"]
    failed = {n for n, v in res["verdicts"].items() if v == "fail"}
    assert failed == {component}
    assert not res["port_vs_jax0"][component] and all(res["jax1_vs_jax0"].values())


def test_bar_on_vectors_needs_every_element(rec):
    ref = _summary(lamda=(0.15, 0.15))
    port = _summary(lamda=(0.15, 0.30))
    res = rec.crosscheck(port, ref, _summary(lamda=(0.15, 0.15)))
    assert res["verdicts"]["lamda mean in the reference's interval"] == "fail"


def test_bar_is_not_decidable_where_the_reference_fails(rec):
    ref = _summary()
    jax1 = _summary(gain=7.2, mcc=0.9)  # the reference's own second fit disagrees
    port = _summary(gain=7.3, mcc=0.88)
    res = rec.crosscheck(port, ref, jax1)
    undecided = {"gain mean in the reference's interval",
                 "the reference's gain mean in its interval", "|dMCC| <= 0.02"}
    assert set(res["not_decidable"]) == undecided
    assert all(res["verdicts"][n] == rec.NOT_DECIDABLE for n in undecided)
    assert res["ok"]  # what the reference cannot decide is not gated
    assert res["mcc"] == {"port": 0.88, "jax0": 0.95, "jax1": 0.9}


# -- rehearsals on the CPU --------------------------------------------------------


def test_recovery_script_crosstalk_rehearsal_on_cpu(rec, capsys):
    """scripts/recovery_torch.py --model crosstalk for 3 steps on the CPU:
    the bounds of check_crosstalk on the golden's two-channel data, and the
    bar against the JAX fits."""
    rc = rec.main("crosstalk", iters=3, device="cpu")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == (0 if out["ok"] else 1) == 1  # 3 steps recover nothing
    assert out["model"] == "crosstalk" and out["iters"] == 3 and out["device"] == "cpu"
    assert set(out["values"]) == {"gain", "alpha_00", "alpha_11", "mcc"}
    assert len(out["bounds"]) == 4
    assert all(np.isfinite(v) for v in out["values"].values())
    check = out["crosscheck"]
    assert check["golden"] == "crosscheck_jax_crosstalk.npz"
    assert check["jax_steps"] == [8000, 8000]
    assert set(check["verdicts"]) == set(check["port_vs_jax0"]) == set(check["jax1_vs_jax0"])
    assert np.asarray(check["port"]["alpha"]["Mean"]).shape == (2, 2)
    assert np.asarray(check["port"]["lamda"]["Mean"]).shape == (2,)
    assert check["mcc"]["port"] == out["values"]["mcc"]


def _jax_result_keys():
    """The keys of the JSON line of scripts/elife_convergence.py, read from
    its source."""
    tree = ast.parse((ROOT / "scripts" / "elife_convergence.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "result" for t in node.targets)):
            keys |= {k.value for k in node.value.keys}
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.targets[0].value, ast.Name)
                and node.targets[0].value.id == "result"):
            keys.add(node.targets[0].slice.value)
    return keys


SMALL = dict(Nt=16, F=32, P=14, n_chunk=8)


@pytest.mark.parametrize("model", MODELS)
def test_elife_convergence_rehearsal_on_cpu(model, elife, tmp_path, monkeypatch, capsys):
    """scripts/elife_convergence_torch.py at Nt=16, F=32 for 5 steps on the
    CPU: the dataset, the fit, the stats and (cosmos+hmm) the kinetics
    commands, ending in one JSON line with the JAX script's keys."""
    monkeypatch.setenv("CI", "true")  # no rastergram
    monkeypatch.setattr(elife, "KINETICS", {"ttfb": (8, 20), "dwelltime": (8, 20)})
    out = tmp_path / model
    res = elife.main(["--model", model, "--iters", "5", "--out", str(out)], device="cpu",
                     dataset_shape=SMALL)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == set(res) and line["summary"].keys() == res["summary"].keys()
    jax_keys = _jax_result_keys()
    assert "kinetics" in jax_keys and "summary" in jax_keys
    want = jax_keys | {"nvidia_smi"}
    if model != "cosmos+hmm":
        want.discard("kinetics")
    assert set(line) == want
    assert line["device"] == "cpu" and line["nvidia_smi"] is None
    assert (line["Nt"], line["F"], line["C"]) == (16, 32, 2 if model == "crosstalk" else 1)
    assert line["iters"] == line["iters_this_invocation"] == 5
    assert line["steps_per_sec_sustained"] > 0 and line["wall_stats_s"] > 0
    assert 0 <= line["p_specific_mean_ontarget"] <= 1
    assert {"gain", "lamda", "proximity", "MCC"} <= set(line["summary"])
    assert (out / f"{model}_params.tpqr").exists()
    if model == "cosmos+hmm":
        kin = line["kinetics"]
        assert kin["truth"] == {"kon": 0.02, "koff": 0.2}
        assert {"ttfb", "kon", "koff"} <= set(kin), kin
    if model != "cosmos":
        return
    # a second call resumes the workspace's checkpoint on the saved dataset
    res2 = elife.main(["--model", model, "--iters", "5", "--out", str(out)], device="cpu",
                      dataset_shape=SMALL)
    assert res2["iters"] == 10 and res2["iters_this_invocation"] == 5


def test_elife_rows_every_n_steps_in_one_process(elife, tmp_path, capsys):
    """``--row-every 3 --iters 7``: three JSON lines (iterations 3, 6, 7)
    from one process, each of the fit as it is then (the posterior caches
    dropped between rows), each followed by the checkpoints' extremes on
    standard error; the last line is what ``main`` returns."""
    out = tmp_path / "rows"
    res = elife.main(["--iters", "7", "--row-every", "3", "--out", str(out)], device="cpu",
                     dataset_shape=SMALL)
    captured = capsys.readouterr()
    lines = [json.loads(ln) for ln in captured.out.strip().splitlines()]
    assert [ln["iters"] for ln in lines] == [3, 6, 7]
    assert [ln["iters_this_invocation"] for ln in lines] == [3, 3, 1]
    assert lines[-1] == json.loads(json.dumps(res))
    assert lines[0]["p_specific_mean_ontarget"] != lines[1]["p_specific_mean_ontarget"]
    extremes = [ln for ln in captured.err.splitlines() if "[elife] checkpoints to" in ln]
    assert len(extremes) == 3 and all("-ELBO finite=True" in ln for ln in extremes)
    assert "diverged" not in captured.err


@pytest.mark.parametrize("name,value", [("gain_beta", 31.0), ("proximity_size", -31.0)],
                         ids=["gain_beta-above-the-clamp", "proximity_size-below-it"])
def test_elife_run_ending_at_the_clamp_exits_1(name, value, elife, tmp_path, capsys):
    """A fit that ends with a global parameter's unconstrained value past
    the exp(+-30) clamp (injected into the workspace's checkpoint; the
    clamp's zero gradient keeps it there) is reported on standard error
    and exits 1 after its JSON line (a healthy fit does not:
    :func:`test_elife_rows_every_n_steps_in_one_process`)."""
    out = tmp_path / "ws"
    elife.main(["--iters", "2", "--out", str(out)], device="cpu", dataset_shape=SMALL)
    ckpt = out / ".tapqir" / "cosmos_model.tpqr"
    with np.load(ckpt) as z:
        flat = {k: z[k] for k in z.files}
    flat[f"p::{name}"] = np.full_like(flat[f"p::{name}"], value)
    with open(ckpt, "wb") as f:
        np.savez(f, **flat)
    capsys.readouterr()
    with pytest.raises(SystemExit) as exc:
        elife.main(["--iters", "1", "--out", str(out)], device="cpu", dataset_shape=SMALL)
    assert exc.value.code == 1
    captured = capsys.readouterr()
    line = json.loads(captured.out.strip().splitlines()[-1])
    assert line["iters"] == 3 and set(line) == _jax_result_keys() - {"kinetics"} | {"nvidia_smi"}
    assert f"[elife] diverged: {name} at the exp(+-30) clamp at iteration 3" in captured.err


def test_elife_build_dataset_layout_matches_the_jax_script(elife, tmp_path):
    """build_dataset puts every chunk's on-target rows first and
    concatenates the chunks' labels in order, as the JAX script's does; the
    port's draws are its own simulator's."""
    from tapqir_tpu_torch.utils.simulate import simulate

    jax_script = _script("elife_convergence", ROOT / "scripts" / "elife_convergence.py")
    want = jax_script.build_dataset(tmp_path / "jax", model_name="cosmos", **SMALL)
    got = elife.build_dataset(tmp_path / "port", model_name="cosmos", device="cpu",
                              **SMALL)
    assert got.images.shape == want.images.shape == (16, 32, 1, 14, 14)
    assert np.array_equal(got.is_ontarget, want.is_ontarget)
    assert got.is_ontarget[:8].all() and not got.is_ontarget[8:].any()
    assert got.labels.dtype == want.labels.dtype and got.labels.shape == want.labels.shape
    for field in ("aoi", "frame"):
        assert np.array_equal(got.labels[field], want.labels[field])
    assert np.array_equal(got.offset.samples, want.offset.samples)
    assert np.allclose(got.offset.weights, want.offset.weights, rtol=1e-15, atol=0)
    assert got.name == want.name == "elife-scale-cosmos"

    chunks = [simulate("cosmos", N=2, F=32, C=1, P=14, seed=i,
                       params=elife.model_sim_params("cosmos"), device="cpu")
              for i in range(8)]
    assert np.array_equal(got.labels, np.concatenate([d.labels for d in chunks]))
    assert np.array_equal(got.images[:8], np.concatenate([d.images[:1] for d in chunks]))
    assert np.array_equal(got.images[8:], np.concatenate([d.images[1:] for d in chunks]))
    # reloaded, not simulated again, when the workspace holds that shape
    again = elife.build_dataset(tmp_path / "port", model_name="cosmos", device="cpu",
                                **SMALL)
    assert np.array_equal(again.images, got.images)
    assert elife.model_sim_params("cosmos+hmm") == jax_script.model_sim_params("cosmos+hmm")
    assert elife.model_sim_params("crosstalk") == jax_script.model_sim_params("crosstalk")


def test_elife_entry_raises_without_a_card(elife, tmp_path):
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        elife.main(["--out", str(tmp_path)])
    assert not list(tmp_path.iterdir())


def test_chip_smoke_convergence_phase_tiny_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phase 26 at a tiny size on the CPU: the eLife script's
    cosmos path on the dataset the main path saved, then the recovery
    script's cosmos path on the golden's data, each checked for what holds
    at any budget."""
    monkeypatch.setenv("CI", "true")  # no rastergram
    cs = _script("chip_smoke", ROOT / "chip_smoke.py")
    cs.prepare_dataset(tmp_path, Nt=16, F=12, P=14, J=7, device="cpu", n_chunk=2)
    res = cs.run_convergence_scripts(tmp_path, num_iter=3, device="cpu",
                                     dataset_shape=dict(Nt=16, F=12))
    cs.check_convergence_scripts(res, num_iter=3, device="cpu")
    assert (tmp_path / "elife" / "data.tpqr").is_symlink()
    assert res["elife"]["Nt"] == 16 and res["elife"]["F"] == 12
    no_launches = dict.fromkeys(("summed_fwd", "summed_stats", "pixel_fwd", "pixel_stats",
                                 "factored_stats", "gather", "adam", "render", "render_grad",
                                 "spot_tables", "spot_tables_grad", "spot_tables_prox",
                                 "chain_scan", "chain_scan_grad"), 0)
    assert res["elife_launches"] == res["recovery_launches"] == no_launches
    assert res["recovery"]["crosscheck"]["golden"] == "crosscheck_jax_cosmos.npz"
    assert len(res["elife_losses"]) == 1 and res["recovery"]["iters"] == 3
    # what holds at any budget is all the phase gates: a broken interval fails it
    res["elife_intervals"]["gain"]["LL"] = res["elife_intervals"]["gain"]["UL"] + 1
    with pytest.raises(RuntimeError, match="eLife intervals"):
        cs.check_convergence_scripts(res, num_iter=3, device="cpu")
