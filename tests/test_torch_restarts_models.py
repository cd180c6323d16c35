"""Batched random restarts of cosmos+hmm and crosstalk on the CPU: the
port's ``fit_restarts`` against the JAX package's in float64 at rtol 1e-6
(dense and ``use_factored``; the JAX run's initial parameters, batches and
packed draws fed through the port's seams, recorded with each model's
``_jax_loss_draws`` of tests/test_torch_hmm.py and
tests/test_torch_crosstalk.py), each chain of a chain-batched ELBO against
the single-chain ELBO with the same batch and draws, and one likelihood
call per restart step for all chains, in every model and route; and a
tiny CPU rehearsal of chip_smoke.py's restart phases 18-19."""

import importlib

import jax
import numpy as np
import optax
import pytest
import torch

from _torch_port_data import (
    assert_restarts_match,
    counted,
    jax_restart_inputs,
    port_restart_args,
)
from tapqir_tpu_torch.parallel.restarts import fit_restarts, stack_params
from test_torch_cosmos import _models as cosmos_models
from test_torch_crosstalk import _jax_loss_draws as xtalk_loss_draws
from test_torch_crosstalk import _models as xtalk_models
from test_torch_hmm import _jax_loss_draws as hmm_loss_draws
from test_torch_hmm import _models as hmm_models

torch.set_num_threads(1)
RTOL = 1e-6
port_cosmos_module = importlib.import_module("tapqir_tpu_torch.models.cosmos")
port_xtalk_module = importlib.import_module("tapqir_tpu_torch.models.crosstalk")


@pytest.fixture(scope="module", autouse=True)
def _restore_x64_after_module():
    """The float64 JAX models here turn x64 on; put the flag back when the
    module is done so that it cannot leak into float32 fits."""
    old = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", old)


def _hmm(monkeypatch):
    jm, tm = hmm_models(2, Nt=4, F=5)

    def record(m, key):
        ndx, _, draws, _ = hmm_loss_draws(m, key, monkeypatch, grad=False)
        return ndx, None, m.data.F, draws

    return jm, tm, record


def _crosstalk(monkeypatch):
    jm, tm = xtalk_models(2, 4, Nt=4, F=5)

    def record(m, key):
        ndx, fidx, f, _, draws, _, _ = xtalk_loss_draws(m, key, monkeypatch, grad=False)
        return ndx, fidx, f, draws

    return jm, tm, record


MODELS = {"cosmos+hmm": _hmm, "crosstalk": _crosstalk}


@pytest.mark.parametrize("factored", [False, True], ids=["dense", "factored"])
@pytest.mark.parametrize("name", list(MODELS))
def test_fit_restarts_matches_jax(name, factored, monkeypatch):
    R, T = 3, 2
    jm, tm, record = MODELS[name](monkeypatch)
    jm.use_factored = tm.use_factored = factored
    jm.lr = tm.lr = 0.005
    jm.tx = optax.adam(0.005, b1=0.9, b2=0.999, eps=1e-8)
    init, steps = jax_restart_inputs(jm, R, T, 0.1, 2, record)
    from tapqir_tpu.parallel.restarts import fit_restarts as jax_fit_restarts

    j_losses, j_best = jax_fit_restarts(jm, num_restarts=R, num_iter=T, perturb=0.1,
                                        chunk=2)
    params, batches, draws = port_restart_args(init, steps)
    t_losses, t_best = fit_restarts(tm, num_restarts=R, num_iter=T, chunk=2,
                                    params=params, batches=batches, draws=draws)
    assert_restarts_match(tm, t_losses, t_best, jm, j_losses, j_best, RTOL)
    assert not hasattr(tm, "_alpha_sample")  # crosstalk's stash is popped


def _port_model(name):
    if name == "cosmos":
        return cosmos_models(2, 4, Nt=5, F=6)[1]
    if name == "cosmos+hmm":
        return hmm_models(2, Nt=4, F=5)[1]
    return xtalk_models(2, 4, Nt=4, F=5)[1]


@pytest.mark.parametrize("factored", [False, True], ids=["dense", "factored"])
@pytest.mark.parametrize("name", ["cosmos", "cosmos+hmm", "crosstalk"])
def test_chain_elbo_is_each_chains_elbo_in_one_likelihood_call(name, factored,
                                                               monkeypatch):
    """A chain-batched ELBO (R = 3, the packed draw of all chains from one
    generator) equals, chain for chain, the single-chain ELBO on that
    chain's parameters, batch and draws, and its gradients the
    single-chain gradients; the likelihood is called once for all chains,
    with a rate per chain."""
    tm = _port_model(name)
    tm.use_factored = factored
    R = 3
    route = "offset_gamma_factored_summed" if factored else "offset_gamma_log_prob_summed"
    module = port_xtalk_module if name == "crosstalk" else port_cosmos_module
    likelihood = getattr(module, route)
    rates = []

    def spy(*args, **kwargs):
        rates.append(tuple(args[4 if factored else 2].shape))
        return likelihood(*args, **kwargs)

    calls = {"port": 0}
    monkeypatch.setattr(module, route, counted(calls, "port", spy))
    core = importlib.import_module("tapqir_tpu_torch.distributions.core")
    sampler, recorded = core.std_gamma_sample, []

    def recording(conc, generator=None, draws=None):
        out = sampler(conc, generator, draws)
        recorded.append(out.detach())
        return out

    monkeypatch.setattr(core, "std_gamma_sample", recording)
    params = {k: v.requires_grad_(True) for k, v in
              stack_params(tm.params, R, perturb=0.2, seed=5).items()}
    gen = torch.Generator().manual_seed(11)
    ndx, fidx, f = tm._draw_batch(gen, chains=R)
    win = tm.gather_chain_windows(params, ndx, fidx)
    loss = tm.elbo_from_windows(win, gen, ndx, fidx, f, tm._data_dev)
    assert loss.shape == (R,) and calls["port"] == 1 and rates == [(R,)]
    draws = recorded[0]
    assert draws.shape[0] == R
    grads = torch.autograd.grad(loss.sum(), list(params.values()))
    for r in range(R):
        p_r = {k: v[r].detach().clone().requires_grad_(True) for k, v in params.items()}
        f_r = None if fidx is None else fidx[r]
        w_r = tm.gather_windows(p_r, ndx[r], f_r)
        one = tm.elbo_from_windows(w_r, None, ndx[r], f_r, f, tm._data_dev,
                                   draws=draws[r])
        np.testing.assert_allclose(float(loss[r].detach()), float(one.detach()), rtol=1e-12)
        g_r = torch.autograd.grad(one, list(p_r.values()))
        for k, g_all, g_one in zip(p_r, grads, g_r):
            scale = max(float(g_one.abs().max()), 1e-300)
            np.testing.assert_allclose(g_all[r].numpy(), g_one.numpy(), rtol=1e-9,
                                       atol=1e-12 * scale, err_msg=k)
    assert calls["port"] == 1 + R and rates[1:] == [()] * R


def test_chip_smoke_restart_phases_tiny_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phases 18-19 at a tiny size on the CPU: ``fit -R 3
    --restart-iter 4 -it 2`` then ``stats`` in a workspace of its own, with
    :func:`check_cli_restarts`; then ``fit_restarts`` through the API on
    cosmos (factored), hmm (resuming its fit) and crosstalk, with
    :func:`check_api_restarts` and one restart step in float32 against
    float64 (:func:`check_restart_card_vs_cpu`)."""
    from test_torch_lifecycle import _chip_smoke

    monkeypatch.setenv("CI", "true")
    cs = _chip_smoke()
    cs.run_main_path(tmp_path, Nt=8, F=12, P=14, J=7, nbatch=4, fbatch=8, num_iter=2,
                     device="cpu", n_chunk=2)
    res = cs.run_cli_restarts(tmp_path, nbatch=4, fbatch=8, R=3, restart_iter=4,
                              num_iter=2, device="cpu")
    checks = cs.check_cli_restarts(res, 3, 4, 2, device="cpu")
    assert checks["best_chain"] == res["restarts_json"]["best_chain"]
    assert not any(res["launches"].values()) and not res["counts"]  # no kernel on the CPU
    cs.run_cli_fit(tmp_path, nbatch=4, fbatch=8, num_iter=2, device="cpu")
    cs.run_cli_hmm_fit(tmp_path, nbatch=4, num_iter=2, device="cpu")
    xws = tmp_path / "crosstalk"
    xws.mkdir()
    cs.prepare_dataset(xws, Nt=8, F=12, P=14, J=7, device="cpu", n_chunk=2, C=2,
                       params=cs.XTALK_PARAMS)
    cs.run_cli_crosstalk_fit(xws, nbatch=4, fbatch=8, num_iter=2, device="cpu")
    for wdir, name, R, fact in ((tmp_path, "cosmos", 3, True),
                                (tmp_path, "cosmos+hmm", 3, False), (xws, "crosstalk", 2, False)):
        api, model = cs.run_api_restarts(wdir, name, R, num_iter=3, nbatch=4, fbatch=8,
                                         device="cpu", use_factored=fact)
        cs.check_api_restarts(api, model, R, 3)
        assert api["iter_before"] > 0 and model.iter == api["iter_before"] + 3  # resumed
        card = cs.check_restart_card_vs_cpu(model, R, n_aoi=4, n_frames=6, nbatch=2,
                                            fbatch=4)
        assert card["max_rel_err"] <= cs.RESTART_RTOL and len(card["losses_card"]) == R
