"""The port's SVI lifecycle: checkpoints interchangeable with the JAX
package in both directions, the same convergence verdicts on the same
series, NaN recovery, out-of-memory mapping, and chip_smoke.py's main path
at a tiny size on the CPU."""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port_data import numpy_dataset, perturbed_params
from tapqir_tpu.models import models as jax_models
from tapqir_tpu.utils.dataset import save as jax_save
from tapqir_tpu_torch.convert import opt_state_from_jax, params_from_jax
from tapqir_tpu_torch.exceptions import CudaOutOfMemoryError
from tapqir_tpu_torch.models import models
from tapqir_tpu_torch.models.model import key_to_seed, seed_to_key
from tapqir_tpu_torch.ops import offset_gamma as og
from tapqir_tpu_torch.utils.dataset import CosmosDataset, OffsetData

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def workspace(tmp_path):
    jax_save(numpy_dataset(CosmosDataset, OffsetData, Nt=6, F=8, seed=2), tmp_path)
    return tmp_path


def _jax_model(ws):
    jm = jax_models["cosmos"]()
    jm.load(ws)
    jm.init(lr=0.005, nbatch_size=2, fbatch_size=4)
    return jm


def _port_model(ws):
    tm = models["cosmos"](device="cpu")
    tm.load(ws)
    tm.init(lr=0.005, nbatch_size=2, fbatch_size=4)
    return tm


def test_port_resumes_jax_checkpoint(workspace):
    jm = _jax_model(workspace)
    p_np = perturbed_params({k: np.asarray(v) for k, v in jm.params.items()})
    jm.params = {k: jnp.asarray(v, jnp.float32) for k, v in p_np.items()}
    jm.iter, jm.iter_loss = 400, 1234.5
    jm._key = jax.random.PRNGKey(17)
    jm.save_checkpoint()

    tm = _port_model(workspace)
    assert tm.iter == 400
    assert tm._seed == key_to_seed(np.asarray(jax.random.PRNGKey(17)))
    for k, v in jm.params.items():
        assert torch.equal(tm.params[k], torch.tensor(np.asarray(v))), k
    adam = jm.opt_state[0]
    for k in ("g", "a", "af"):
        np.testing.assert_array_equal(tm.opt_state["count"][k].numpy(), np.asarray(adam.count[k]))
    tm.run(3)
    assert tm.iter == 403
    assert all(torch.isfinite(v).all() for v in tm.params.values())


def test_jax_resumes_port_checkpoint(workspace):
    tm = _port_model(workspace)
    tm.run(3)
    jm = _jax_model(workspace)
    assert jm.iter == 3 and tm.iter == 3
    for k, v in tm.params.items():
        np.testing.assert_array_equal(np.asarray(jm.params[k]), v.numpy(), err_msg=k)
    adam = jm.opt_state[0]
    for k, v in tm.opt_state["count"].items():
        np.testing.assert_array_equal(np.asarray(adam.count[k]), v.numpy(), err_msg=k)
    for k, v in tm.opt_state["mu"].items():
        np.testing.assert_array_equal(np.asarray(adam.mu[k]), v.numpy(), err_msg=k)
    # the port's seed rides in rng::key as a uint32[2] the JAX package uses as a key
    np.testing.assert_array_equal(np.asarray(jm._key), seed_to_key(tm._seed))
    assert key_to_seed(seed_to_key(tm._seed)) == tm._seed


def test_params_and_opt_state_from_jax(workspace):
    jm = _jax_model(workspace)
    params = params_from_jax({k: np.asarray(v) for k, v in jm.params.items()}, "cpu")
    assert all(v.dtype == torch.float32 for v in params.values())
    for k, v in jm.params.items():
        assert torch.equal(params[k], torch.tensor(np.asarray(v)))
    adam = jm.opt_state[0]
    opt = opt_state_from_jax(
        {k: np.asarray(v) for k, v in adam.mu.items()},
        {k: np.asarray(v) for k, v in adam.nu.items()},
        {k: np.asarray(v) for k, v in adam.count.items()}, "cpu",
    )
    assert set(opt) == {"mu", "nu", "count"}
    assert opt["count"]["af"].dtype == torch.int32
    with pytest.raises(ValueError):
        opt_state_from_jax({}, {}, np.asarray(3), "cpu")


@pytest.mark.parametrize("converging", [True, False])
def test_convergence_verdicts_match_jax(workspace, converging):
    rng = np.random.default_rng(3)
    jm = _jax_model(workspace)
    tm = _port_model(workspace)
    tm.params = params_from_jax({k: np.asarray(v) for k, v in jm.params.items()}, "cpu")
    # each series centred on the value the checkpoint appends to it: a
    # stationary one (the same 50 fluctuations twice) or a decaying one
    centre = {"-ELBO": 10.0, "proximity_loc": float(tm.param("proximity_loc")),
              "gain_loc": float(tm.param("gain_loc")),
              "lamda_loc_0": float(tm.param("lamda_loc")[0])}
    series = {}
    for k, c in centre.items():
        base = rng.normal(size=50) * 1e-3
        noise = (np.concatenate([base[1:], base]) if converging
                 else rng.normal(size=99) * np.linspace(5e-3, 1e-4, 99))
        series[k] = list(noise + c)
    for m in (jm, tm):
        m._rolling = {k: list(v) for k, v in series.items()}
        m.iter, m.iter_loss = 20000, 10.0
        m.save_checkpoint()
    assert jm.converged == tm.converged == converging


def test_nan_loss_reloads_checkpoint_and_reseeds(workspace, caplog):
    tm = _port_model(workspace)
    tm.run(2)
    real_step = tm._sparse_step
    calls = {"n": 0}

    def nan_once(gen, batch=None, draws=None):
        calls["n"] += 1
        loss = real_step(gen, batch, draws)
        return loss * float("nan") if calls["n"] == 1 else loss

    tm._sparse_step = nan_once
    tm.run(2)
    assert "Detected NaN/Inf loss values" in caplog.text
    assert "restarting with a new seed" in caplog.text
    assert tm.iter == 4

    tm._sparse_step = lambda gen, batch=None, draws=None: torch.tensor(float("nan"))
    with pytest.raises(RuntimeError, match="non-finite after"):
        tm.run(2)


def test_out_of_memory_maps_to_typed_exception(workspace, monkeypatch):
    tm = _port_model(workspace)

    def oom(nsteps):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(tm, "_run_chunk", oom)
    with pytest.raises(CudaOutOfMemoryError):
        tm.run(2)


def _script(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _chip_smoke():
    return _script("chip_smoke", ROOT / "chip_smoke.py")


def test_chip_smoke_main_path_tiny_on_cpu(tmp_path):
    cs = _chip_smoke()
    res = cs.run_main_path(tmp_path, Nt=8, F=12, P=14, J=7, nbatch=4, fbatch=8,
                           num_iter=6, device="cpu", n_chunk=2)
    cs.check_main_path(res, 6)
    assert res["checkpoint_exists"] and res["iter_reloaded"] == 6
    assert res["launches"] == dict.fromkeys(og.LAUNCHERS, 0)  # the CPU takes the plain path
    # resume from the checkpoint: iter advances from where it stopped
    tm = models["cosmos"](device="cpu")
    tm.load(tmp_path)
    tm.init(lr=0.005, nbatch_size=4, fbatch_size=8)
    assert tm.iter == 6
    tm.run(4)
    assert tm.iter == 10


def test_chip_smoke_cli_fit_and_stats_tiny_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phases 10-11 at a tiny size on the CPU: the command
    line's fit resumes the dense fit's checkpoint and ends in the stats,
    stats repeats them bitwise, and the stats' arithmetic in float32 agrees
    with float64."""
    monkeypatch.setenv("CI", "true")  # no rastergram
    cs = _chip_smoke()
    res = cs.run_main_path(tmp_path, Nt=8, F=12, P=14, J=7, nbatch=4, fbatch=8,
                           num_iter=6, device="cpu", n_chunk=2)
    cs.check_main_path(res, 6)
    fit = cs.run_cli_fit(tmp_path, nbatch=4, fbatch=8, num_iter=4, device="cpu")
    cs.check_cli_fit(fit, 4, device="cpu")
    assert fit["iter_before"] == 6 and fit["model"].iter == 10
    assert fit["launches"] == dict.fromkeys(og.LAUNCHERS, 0)  # the CPU takes the plain path
    assert set(fit["model"].stats_seconds) == {
        "probabilities", "credible_intervals", "snr_chi2", "files"}
    stats = cs.run_cli_stats(tmp_path, device="cpu")
    checks = cs.check_cli_stats(stats, fit)
    assert checks["z_probs_bitwise_equal_to_fit"]
    model = stats["model"]
    assert model.data.N == 4 and model.data.labels.shape == (4, 12, 1)
    np.testing.assert_array_equal(model.data.is_ontarget, [1, 1, 1, 1, 0, 0, 0, 0])
    # here the model's float32 on the CPU against float64
    assert model.dtype == torch.float32
    card = cs.check_card_vs_cpu(model, nbatch=4, fbatch=8, num_particles=5, n_aoi=3)
    assert card["block"] == [4, 8] and card["snr_aois"] == 3


def test_chip_smoke_factored_and_pixel_paths_tiny_on_cpu(tmp_path):
    """chip_smoke.py's factored fit (on the dataset the dense path saved,
    linked) and its per-pixel path, at a tiny size on the CPU."""
    cs = _chip_smoke()
    cs.prepare_dataset(tmp_path, Nt=8, F=12, P=14, J=7, device="cpu", n_chunk=2)
    res, model = cs.run_factored_path(tmp_path, nbatch=4, fbatch=8, num_iter=4,
                                      device="cpu")
    cs.check_main_path(res, 4)
    assert model.use_factored and (tmp_path / "factored" / "data.tpqr").is_symlink()
    assert res["launches"] == dict.fromkeys(og.LAUNCHERS, 0)
    pixel = cs.run_pixel_path(model.data, n_aoi=2, n_frames=5, device="cpu")
    assert pixel["shape"] == [2, 5, 1, 14, 14]
    assert pixel["launches"] == dict.fromkeys(og.LAUNCHERS, 0)


def test_recovery_script_rehearsal_on_cpu(capsys):
    """scripts/recovery_torch.py for 3 steps on the CPU: the whole script
    runs and prints its JSON line; 3 steps recover nothing, so it exits 1."""
    rec = _script("recovery_torch", ROOT / "scripts" / "recovery_torch.py")
    assert rec.ITERS == 8000 and rec.SEED == 0
    rc = rec.main(iters=3, device="cpu")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == (0 if out["ok"] else 1)
    assert out["iters"] == 3 and out["device"] == "cpu"
    assert set(out["values"]) == {"gain", "proximity", "lamda", "pi_1", "mcc"}
    assert len(out["bounds"]) == 5
    assert all(np.isfinite(v) for v in out["values"].values())
    assert out["fit_seconds"] > 0 and out["steps_per_s"] > 0


def test_chip_smoke_hmm_phases_tiny_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phases 12-13 at a tiny size on the CPU: after the
    cosmos fit, the command line's fit and its stats (phases 7, 10, 11),
    the command line's hmm fit warm-starts from them and ends in the stats,
    and the hmm ELBO and a theta block in float32 agree with float64."""
    monkeypatch.setenv("CI", "true")  # no rastergram
    cs = _chip_smoke()
    res = cs.run_main_path(tmp_path, Nt=8, F=12, P=14, J=7, nbatch=4, fbatch=8,
                           num_iter=6, device="cpu", n_chunk=2)
    cs.check_main_path(res, 6)
    fit = cs.run_cli_fit(tmp_path, nbatch=4, fbatch=8, num_iter=2, device="cpu")
    cs.check_cli_fit(fit, 2, device="cpu")
    cs.check_cli_stats(cs.run_cli_stats(tmp_path, device="cpu"), fit)

    hmm = cs.run_cli_hmm_fit(tmp_path, nbatch=4, num_iter=4, device="cpu")
    checks = cs.check_cli_hmm_fit(hmm, 4, device="cpu")
    assert hmm["launches"] == dict.fromkeys(og.LAUNCHERS, 0)  # the CPU takes the plain path
    assert hmm["shapes"] == set() and hmm["run_seconds"] > 0
    assert checks["warm_start_max_abs_err"] <= cs.WARM_TOL
    model = hmm["model"]
    assert model.iter == 4 and model.dtype == torch.float32
    assert set(model.stats_seconds) == {
        "probabilities", "credible_intervals", "snr_chi2", "files"}
    assert (tmp_path / "cosmos+hmm_params.tpqr").exists()
    card = cs.check_hmm_card_vs_cpu(model, n_elbo=2, nbatch=4, num_particles=5)
    assert card["elbo_images"] == 2 * 12 and card["theta_block"] == [4, 12]
    assert card["launches"] == dict.fromkeys(og.LAUNCHERS, 0)
    assert card["elbo_card_vs_cpu_rel_err"] <= cs.HMM_ELBO_RTOL


def test_recovery_script_hmm_rehearsal_on_cpu(capsys):
    """scripts/recovery_torch.py --model cosmos+hmm for 3 steps on the CPU:
    the bounds of check_hmm (kon, koff in place of pi) on N=12, F=80."""
    rec = _script("recovery_torch", ROOT / "scripts" / "recovery_torch.py")
    assert rec.CONFIGS["cosmos+hmm"][1:] == (12, 80, 16000)
    rc = rec.main("cosmos+hmm", iters=3, device="cpu")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == (0 if out["ok"] else 1)
    assert out["model"] == "cosmos+hmm" and out["iters"] == 3
    assert set(out["values"]) == {"gain", "proximity", "lamda", "kon", "koff", "mcc"}
    assert len(out["bounds"]) == 6
    assert all(np.isfinite(v) for v in out["values"].values())


def test_chip_smoke_crosstalk_phases_tiny_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phases 14-15 at a tiny size on the CPU: the command
    line's crosstalk fit on a two-channel workspace ends in the stats, the
    factored route continues it through Model.run, and the crosstalk ELBO
    and the stats' arithmetic in float32 agree with float64."""
    monkeypatch.setenv("CI", "true")  # no rastergram
    cs = _chip_smoke()
    cs.prepare_dataset(tmp_path, Nt=8, F=12, P=14, J=7, device="cpu", n_chunk=2, C=2,
                       params=cs.XTALK_PARAMS)
    fit = cs.run_cli_crosstalk_fit(tmp_path, nbatch=4, fbatch=8, num_iter=4, device="cpu")
    checks = cs.check_cli_crosstalk_fit(fit, 4, device="cpu")
    assert fit["launches"] == dict.fromkeys(og.LAUNCHERS, 0)  # the CPU takes the plain path
    assert fit["shapes"] == set() and fit["run_seconds"] > 0
    assert np.array(checks["alpha"]).shape == (2, 2) and len(checks["SNR"]) == 2
    model = fit["model"]
    assert "run" not in vars(model)  # the timing wrapper went with the command's run
    assert model.iter == 4 and model.Q == model.data.C == 2
    assert model.data.labels.shape == (4, 12, 2)
    fact = cs.run_crosstalk_factored(model, num_iter=3)
    cs.check_crosstalk_factored(fact, model, 3)
    assert model.iter == 7 and not model.use_factored and fact["shapes"] == set()
    card = cs.check_crosstalk_card_vs_cpu(model, n_aoi=2, n_frames=5)
    assert card["elbo_images"] == 2 * 5 * 2
    assert card["launches"] == dict.fromkeys(og.LAUNCHERS, 0)
    assert card["elbo_card_vs_cpu_rel_err"] <= cs.XTALK_ELBO_RTOL
    probs = cs.check_card_vs_cpu(model, nbatch=4, fbatch=8, num_particles=5, n_aoi=3)
    assert probs["block"] == [4, 8] and probs["snr_aois"] == 3


def test_chip_smoke_kinetics_phase_tiny_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phase 16 at a tiny size on the CPU: ``ttfb`` on the
    cosmos fit and ``dwelltime`` on the hmm fit of the same workspace, each
    fit refitted on the CPU in float64 for its first rows."""
    monkeypatch.setenv("CI", "true")
    cs = _chip_smoke()
    cs.run_main_path(tmp_path, Nt=8, F=12, P=14, J=7, nbatch=4, fbatch=8, num_iter=2,
                     device="cpu", n_chunk=2)
    fit = cs.run_cli_fit(tmp_path, nbatch=4, fbatch=8, num_iter=2, device="cpu")
    cs.check_cli_fit(fit, 2, device="cpu")
    hmm = cs.run_cli_hmm_fit(tmp_path, nbatch=4, num_iter=2, device="cpu")
    cs.check_cli_hmm_fit(hmm, 2, device="cpu")

    ttfb = cs.run_kinetics(tmp_path, ["ttfb", "--model", "cosmos", "-n", "20", "-it", "30"],
                           device="cpu", cpu_rows=5, cpu_elems=12)
    tables = cs.check_kinetics(ttfb, "ttfb", 1, 1, device="cpu")
    assert set(tables["params-channel0"]) == {"ka", "kns", "Af"}
    assert ttfb["z_samples_shape"] == [20, 4, 12, 1] and ttfb["fits"] == [("ttfb_mle", [20, 4])]
    assert ttfb["mle_rel_err"] == 0.0  # the same rows on the same device
    assert ttfb["cpu_refit_rows"] == [3]  # 12 values of rows of 4 AOIs
    assert {"cosmos_ttfb-data-points-channel0.csv", "cosmos_ttfb-params-channel0.csv",
            "cosmos_ttfb-fraction-bound-channel0.csv"} <= set(ttfb["files"])
    dwell = cs.run_kinetics(tmp_path, ["dwelltime", "--model", "cosmos+hmm", "-K", "1",
                                       "-n", "10", "-it", "30"], device="cpu", cpu_rows=5)
    tables = cs.check_kinetics(dwell, "dwelltime", 1, 2, device="cpu")
    assert set(tables) == {"kon-channel0", "koff-channel0"}
    assert set(tables["koff-channel0"]) == {"A0", "koff0"}
    assert [f[0] for f in dwell["fits"]] == ["exp_mle", "exp_mle"]
    assert "cosmos+hmm_dwelltime-intervals-channel0.mat" in dwell["files"]


def test_chip_smoke_ingest_phases_tiny_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phases 20-21 at a tiny size on the CPU: a 64 x 64
    raw Glimpse folder of 12 frames and 8 AOIs through ``glimpse`` (crops
    bitwise, both decoders bitwise), then ``fit``, ``fit --profile``,
    ``stats``, ``subset`` and ``log`` on the ingested workspace."""
    monkeypatch.setenv("CI", "true")
    cs = _chip_smoke()
    raw = cs.write_glimpse_folder(tmp_path / "raw", H=64, W=64, F=12, Nt=8,
                                  offset=(0, 0, 8))
    assert np.abs(raw["truth"] - raw["truth"][:, 6:7]).max() <= 2.0  # drift within 2 px
    ws = tmp_path / "ws"
    ws.mkdir()
    ingest = cs.run_ingest(ws, raw)
    assert ingest["checks"]["crops_bitwise_equal"] and ingest["checks"]["images"] == [
        8, 12, 1, 14, 14]
    assert ingest["decoders"]["frames"] == 12
    assert set(ingest["stage_seconds"]) == {"parse", "decode", "crop", "histogram",
                                            "assemble", "save"}
    res = cs.run_ingested_cli(ws, nbatch=4, num_iter=3, n_profile=2, n_subset=5,
                              device="cpu")
    checks = cs.check_ingested_cli(res, num_iter=3, n_profile=2, device="cpu")
    assert checks["launch_shape"] == ["summed_stats", 4, 4 * 12]
    assert checks["subset"] == [5, 12, 1, 14, 14]
    assert all(r["launches"] == dict.fromkeys(og.LAUNCHERS, 0) for r in res.values())
    assert res["fit"]["model"].iter == 3 and res["profile"]["trace_bytes"] > 0


def test_chip_smoke_viewer_phase_tiny_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phase 25 at a tiny size on the CPU, on a workspace
    made as phases 20-21 make theirs: the viewer's checks with matplotlib
    (show writes the PNG), then again without it (show exits 1 naming it),
    and no kernel launched either time."""
    monkeypatch.setenv("CI", "true")
    cs = _chip_smoke()
    raw = cs.write_glimpse_folder(tmp_path / "raw", H=64, W=64, F=12, Nt=8,
                                  offset=(0, 0, 8))
    ws = tmp_path / "ws"
    ws.mkdir()
    assert cs.run_ingest(ws, raw)["code"] == 0
    assert cs.run_cli(ws, ["fit", "-n", "4", "-f", "12", "-it", "2", "--no-input"],
                      device="cpu")["code"] == 0
    res = cs.run_viewer(ws, H=64, W=64, window=3, excluded=(1, 5, 100), device="cpu")
    assert res["matplotlib"] and res["show_exit"] == 0 and res["png_bytes"] > 0
    assert (res["aois"], res["frames"], res["excluded"], res["subset_aois"]) == (
        8, 12, [1, 5, 7], 5)
    assert res["launches"] == dict.fromkeys(og.LAUNCHERS, 0)
    (ws / "cosmos_aoi0-channel0.png").unlink()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    res = cs.run_viewer(ws, H=64, W=64, window=3, excluded=(2,), device="cpu")
    assert not res["matplotlib"] and res["show_exit"] == 1 and res["png_bytes"] == 0
    assert res["excluded"] == [1, 2, 5, 7]  # the saved exclusions are kept


def test_chip_smoke_mesh_phases_tiny_on_cpu(tmp_path, monkeypatch, capsys):
    """chip_smoke.py's phases 22-24 at a tiny size on CPU ranks (gloo): the
    cosmos 2x2 mesh with its replica, card-vs-CPU step, checkpoint and
    posterior checks, cosmos+hmm on 1x2 with the sharded scan, crosstalk
    on 2x1, and restarts on 2x2 through the command line's restarts; the
    CPU launches no kernel."""
    monkeypatch.setenv("CI", "true")  # no rastergram
    cs = _chip_smoke()
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)  # the ranks import it by name
    cs.prepare_dataset(tmp_path, Nt=8, F=12, P=14, J=7, device="cpu", n_chunk=2)
    xws = tmp_path / "crosstalk"
    xws.mkdir()
    cs.prepare_dataset(xws, Nt=8, F=12, P=14, J=7, device="cpu", n_chunk=2, C=2,
                       params=cs.XTALK_PARAMS)
    res = cs.run_mesh_phases(tmp_path, xws, ["cpu"] * 4, nbatch=2, fbatch=4, num_iter=2,
                             R=2, more_iter=1, kernels=False, warmup=1)
    checks = cs.check_mesh_phases(res, num_iter=2, R=2, more_iter=1, Nt=8, F=12,
                                  device="cpu")
    assert checks["replicas_equal"] and res["22 mesh cosmos"]["local"] == [4, 6]
    assert res["23 mesh hmm + crosstalk"]["hmm_local"] == [8, 6]
    for r in res.values():
        assert not any(r["launches"].values())
    cs.print_mesh_phases(res, checks, None, "cpu", "no card")
    assert "[mesh-restarts]" in capsys.readouterr().out
