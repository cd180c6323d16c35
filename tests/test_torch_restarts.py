"""Batched random restarts on the CPU: the port's ``fit_restarts`` against
the JAX package's for cosmos (dense and ``use_factored``), the
chain-batched plain likelihoods against a per-chain loop and against
``jax.vmap`` of the Pallas summed kernel in interpret mode, the dense Adam
against ``optax.adam``, the restart handoff's step counts, and ``fit -R``
on the command line (hmm and crosstalk: test_torch_restarts_models.py).

``fit_restarts`` is compared in float64 at rtol 1e-6 with the JAX run's
initial parameters, batches and packed draws fed through its seams: losses
(R, T), the best chain, and the winner's parameters, Adam moments and step
counts (moments with an absolute floor of 1e-6 times the array's largest
magnitude, for entries that are zero up to round-off).
"""

import json
import shutil
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from click.testing import CliRunner

from _torch_port_data import (
    assert_restarts_match,
    jax_restart_inputs,
    port_restart_args,
)
from tapqir_tpu.main import app as jax_app
from tapqir_tpu.parallel.restarts import fit_restarts as jax_fit_restarts
from tapqir_tpu_torch import main as cli
from tapqir_tpu_torch.models import models
from tapqir_tpu_torch.models.model import _dense_adam
from tapqir_tpu_torch.ops.offset_gamma import (
    offset_gamma_factored_summed,
    offset_gamma_factored_summed_plain,
    offset_gamma_summed,
    offset_gamma_summed_plain,
)
from tapqir_tpu_torch.parallel.restarts import fit_restarts, stack_params
from tapqir_tpu_torch.utils.dataset import save
from tapqir_tpu_torch.utils.simulate import simulate
from test_torch_cosmos import _jax_loss_draws, _models

torch.set_num_threads(1)
RTOL = 1e-6
PARAMS = {"pi": 0.15, "width": 1.4, "gain": 7.0, "lamda": 0.15, "proximity": 0.2,
          "offset": 90.0, "height": 3000, "background": 150}


@pytest.fixture(scope="module", autouse=True)
def _restore_x64_after_module():
    """The float64 JAX models here turn x64 on; put the flag back when the
    module is done so that it cannot leak into float32 fits."""
    old = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("factored", [False, True], ids=["dense", "factored"])
def test_fit_restarts_matches_jax(factored, monkeypatch):
    R, T = 3, 2
    jm, tm = _models(2, 4, Nt=5, F=6)
    jm.use_factored = tm.use_factored = factored
    jm.lr = tm.lr = 0.005
    jm.tx = optax.adam(0.005, b1=0.9, b2=0.999, eps=1e-8)

    def record(m, key):
        ndx, fidx, f, _, draws, _ = _jax_loss_draws(m, key, monkeypatch, grad=False)
        return ndx, fidx, f, draws

    init, steps = jax_restart_inputs(jm, R, T, 0.1, 2, record)
    j_losses, j_best = jax_fit_restarts(jm, num_restarts=R, num_iter=T, perturb=0.1,
                                        chunk=2)
    params, batches, draws = port_restart_args(init, steps)
    assert batches[0][1].shape == (R, 4)  # each chain its own frames
    t_losses, t_best = fit_restarts(tm, num_restarts=R, num_iter=T, chunk=2,
                                    params=params, batches=batches, draws=draws)
    assert t_losses.shape == (R, T)
    assert_restarts_match(tm, t_losses, t_best, jm, j_losses, j_best, RTOL)


def test_chain_draws_and_stacked_init():
    """Each chain draws its own AOI rows and frames; chain 0 keeps the
    init, the others' jitter is keyed by the parameter's crc32 and the
    seed, not by the order of the parameters."""
    _, tm = _models(2, 4, Nt=5, F=6)
    gen = torch.Generator().manual_seed(3)
    ndx, fidx, f = tm._draw_batch(gen, chains=4)
    assert ndx.shape == (4, 2) and fidx.shape == (4, 4) and f == 4
    for r in range(4):
        assert len(set(ndx[r].tolist())) == 2 and ndx[r].max() < 5
        assert (fidx[r].diff() > 0).all() and fidx[r].max() < 6
    assert len({tuple(r) for r in ndx.tolist()}) > 1  # not one batch for all
    assert len({tuple(r) for r in fidx.tolist()}) > 1
    tm.frame_sampling = "window"
    _, wf, _ = tm._draw_batch(gen, chains=4)
    np.testing.assert_array_equal(wf.numpy(), (wf[:, :1].numpy() + np.arange(4)) % 6)

    stacked = stack_params(tm.params, 3, perturb=0.1, seed=7)
    again = stack_params(dict(reversed(tm.params.items())), 3, perturb=0.1, seed=7)
    for k, v in tm.params.items():
        assert stacked[k].shape == (3,) + v.shape
        assert torch.equal(stacked[k][0], v)
        assert torch.equal(stacked[k], again[k])
        assert not torch.equal(stacked[k][1], stacked[k][2])
    assert zlib.crc32(b"gain_loc") != zlib.crc32(b"gain_beta")


def test_fit_restarts_selects_by_the_trailing_mean_and_reports_per_chunk():
    """The best chain is the lowest mean -ELBO over the last max(1, min(50,
    T // 10)) steps; ``progress`` is called once per chunk with the least
    last loss; the winner's per-row counts are T and ``iter`` grows by T."""
    _, tm = _models(2, 4, Nt=5, F=6)
    tm.lr = 0.005
    tm.iter = 3
    calls = []
    losses, best = fit_restarts(tm, num_restarts=3, num_iter=5, perturb=0.3, chunk=2,
                                progress=lambda it, loss: calls.append((it, loss)))
    assert losses.shape == (3, 5) and np.isfinite(losses).all()
    assert best == int(np.argmin(losses[:, -1:].mean(1)))
    assert [it for it, _ in calls] == [2, 4, 5]
    assert calls[-1][1] == losses[:, -1].min()
    assert tm.iter == 8 and tm.iter_loss == losses[best, -1]
    assert all((v == 5).all() for v in tm.opt_state["count"].values())
    assert tm.params["gain_loc"].shape == ()


def test_dense_adam_matches_optax():
    jax.config.update("jax_enable_x64", True)
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4, 5), "b": (3,), "c": (3, 2, 2)}
    p = {k: rng.standard_normal(s) for k, s in shapes.items()}
    tx = optax.adam(0.01, b1=0.9, b2=0.999, eps=1e-8)
    j_p = {k: jnp.asarray(v) for k, v in p.items()}
    j_opt = tx.init(j_p)
    t_p = {k: torch.tensor(v) for k, v in p.items()}
    mu = {k: torch.zeros_like(v) for k, v in t_p.items()}
    nu = {k: torch.zeros_like(v) for k, v in t_p.items()}
    for t in range(1, 4):
        g = {k: rng.standard_normal(s) * (rng.random(s) < 0.5) for k, s in shapes.items()}
        upd, j_opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, j_opt)
        j_p = optax.apply_updates(j_p, upd)
        _dense_adam(list(t_p.values()), [torch.tensor(g[k]) for k in t_p],
                    list(mu.values()), list(nu.values()), t, 0.01)
    for k in shapes:
        np.testing.assert_allclose(t_p[k].numpy(), np.asarray(j_p[k]), rtol=1e-12)
        np.testing.assert_allclose(mu[k].numpy(), np.asarray(j_opt[0].mu[k]), rtol=1e-12)
        np.testing.assert_allclose(nu[k].numpy(), np.asarray(j_opt[0].nu[k]), rtol=1e-12)


# ---------------------------------------------------------------------------
# the chain-batched likelihoods
# ---------------------------------------------------------------------------


def _chain_case(R=3, M=4, nb=5, ev=196, ev_pad=256, J=7, seed=0, dtype=np.float64):
    """R chains of nb images each, laid out chain-major: value (R*nb, EVP),
    concentration (M, R*nb, EVP), a rate per chain, and a cotangent."""
    rng = np.random.default_rng(seed)
    value = rng.integers(95, 400, size=(R * nb, ev)).astype(dtype)
    conc = rng.uniform(10.0, 80.0, size=(M, R * nb, ev)).astype(dtype)
    g = np.sort(rng.integers(80, 95, size=J)).astype(dtype)
    w = np.log(rng.dirichlet(np.ones(J))).astype(dtype)
    rates = (1.0 / rng.uniform(5.0, 9.0, size=R)).astype(dtype)
    value_p = np.concatenate([value, np.full((R * nb, ev_pad - ev), g.max() + 1.0, dtype)], -1)
    conc_p = np.concatenate([conc, np.ones((M, R * nb, ev_pad - ev), dtype)], -1)
    cot = rng.uniform(-1.0, 1.0, size=(M, R * nb)).astype(dtype)
    return value_p, conc_p, rates, g, w, ev, cot


def _factored_leaves(conc, Kf=2):
    """Base (nb,) and deltas (Kf, nb, EVP) from a dense case's magnitudes."""
    base = conc[0, :, 0] * 0.5
    deltas = np.stack([conc[k] * 0.25 for k in range(Kf)])
    return base, deltas


@pytest.mark.parametrize("form", ["summed", "factored"])
def test_chain_batched_plain_matches_a_loop_over_chains(form):
    """The chain-batched plain version (one call, rates (R,)) against one
    call per chain: values, concentration gradients and each chain's rate
    gradient. CPU tensors take the plain version through the wrappers."""
    R, nb = 3, 5
    value, conc, rates, g, w, ev, cot = _chain_case(R=R, nb=nb)
    x, gg, ww, go = (torch.tensor(a) for a in (value, g, w, cot))
    mtab = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], np.float64)
    if form == "summed":
        leaves = [torch.tensor(conc, requires_grad=True)]

        def fn(sl, ls, r):
            return offset_gamma_summed(x[sl], ls[0][:, sl], r, gg, ww, ev)
    else:
        base, deltas = _factored_leaves(conc)
        leaves = [torch.tensor(base, requires_grad=True),
                  torch.tensor(deltas, requires_grad=True)]

        def fn(sl, ls, r):
            return offset_gamma_factored_summed(x[sl], ls[0][sl], ls[1][:, sl], mtab, r,
                                                gg, ww, ev)
    rate = torch.tensor(rates, requires_grad=True)
    everything = slice(None)
    out = fn(everything, leaves, rate)
    grads = torch.autograd.grad((out * go).sum(), leaves + [rate])
    assert out.shape == (4, R * nb)
    for r in range(R):
        sl = slice(r * nb, (r + 1) * nb)
        ls = [t.detach().clone().requires_grad_(True) for t in leaves]
        r1 = torch.tensor(rates[r], requires_grad=True)
        want = fn(sl, ls, r1)
        w_grads = torch.autograd.grad((want * go[:, sl]).sum(), ls + [r1])
        np.testing.assert_allclose(out[:, sl].detach().numpy(), want.detach().numpy(),
                                   rtol=1e-13)
        for got_g, want_g in zip(grads[:-1], w_grads[:-1]):
            sel = got_g[..., sl, :] if got_g.dim() > 1 else got_g[sl]
            w_sel = want_g[..., sl, :] if want_g.dim() > 1 else want_g[sl]
            np.testing.assert_allclose(sel.numpy(), w_sel.numpy(), rtol=1e-12, atol=1e-300)
        np.testing.assert_allclose(float(grads[-1][r]), float(w_grads[-1]), rtol=1e-12)
    plain = (offset_gamma_summed_plain(x, leaves[0], rate, gg, ww, ev) if form == "summed"
             else offset_gamma_factored_summed_plain(x, *leaves, mtab, rate, gg, ww, ev))
    assert torch.equal(plain, out)
    with pytest.raises(ValueError):  # 2 rates cannot split 15 images
        offset_gamma_summed_plain(x, torch.tensor(conc), rate[:2], gg, ww, ev)


def test_chain_batched_plain_matches_jax_vmap_of_the_pallas_kernel(monkeypatch):
    """``jax.vmap`` over R chains of ``offset_gamma_log_prob_summed(
    use_pallas=True)`` in interpret mode (the batched kernel of
    tests/test_pallas.py:196-222, here with a rate per chain) against the
    port's one chain-batched call, at tests/test_pallas.py's float32
    tolerances (forward rtol 3e-5 / atol 1e-2, gradient rtol 2e-4 / atol
    1e-4, rate rtol 1e-3)."""
    from tapqir_tpu.distributions.ksmogn import offset_gamma_log_prob_summed

    monkeypatch.setenv("TAPQIR_PALLAS_INTERPRET", "1")
    R, M, nb = 3, 4, 6
    value, conc, rates, g, w, ev, cot = _chain_case(R=R, M=M, nb=nb, dtype=np.float32)

    def one(v, a, r, c):
        out = offset_gamma_log_prob_summed(
            v, a, r, jnp.asarray(g), jnp.asarray(w), event_ndims=1, use_pallas=True, ev=ev,
        )
        return (out * c).sum(), out

    per_chain = lambda a: a.reshape(a.shape[:-2] + (R, nb, a.shape[-1]))  # noqa: E731
    vals = jnp.asarray(value).reshape(R, nb, -1)
    concs = jnp.moveaxis(jnp.asarray(per_chain(conc)), -3, 0)  # (R, M, nb, EVP)
    cots = jnp.moveaxis(jnp.asarray(cot).reshape(M, R, nb), 1, 0)
    (_, want), (wa, wr) = jax.vmap(
        jax.value_and_grad(one, argnums=(1, 2), has_aux=True)
    )(vals, concs, jnp.asarray(rates), cots)

    a = torch.tensor(conc, dtype=torch.float64, requires_grad=True)
    r = torch.tensor(rates, dtype=torch.float64, requires_grad=True)
    got = offset_gamma_summed(torch.tensor(value, dtype=torch.float64), a, r,
                              torch.tensor(g, dtype=torch.float64),
                              torch.tensor(w, dtype=torch.float64), ev)
    ga, gr = torch.autograd.grad((got * torch.tensor(cot, dtype=torch.float64)).sum(), (a, r))
    got = got.detach().numpy().reshape(M, R, nb).transpose(1, 0, 2)
    ga = ga.numpy().reshape(M, R, nb, -1).transpose(1, 0, 2, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=3e-5, atol=1e-2)
    np.testing.assert_allclose(ga[..., :ev], np.asarray(wa)[..., :ev], rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(gr.numpy(), np.asarray(wr), rtol=1e-3)


# ---------------------------------------------------------------------------
# the handoff and the command line
# ---------------------------------------------------------------------------


def test_adopt_chain_bias_correction_bound(tmp_path):
    """The handoff (``Model.adopt_chain``, the port of ``_coerce_opt_state``,
    tests/test_model_lifecycle.py:200) fills every per-row step count with
    the restarts' count t_g. For a row sampled with probability r = n/Nt
    the true count is ~r t_g, so the next sparse step's bias-corrected
    update is rescaled by
        factor = [(1-b1^t_r)/(1-b1^t_g)] sqrt[(1-b2^t_g)/(1-b2^t_r)];
    the measured one-step difference must stay within it, below 5% at
    t_g = 10000 and r = 1/4, and globals must match exactly."""
    save(simulate("cosmos", N=4, F=16, C=1, P=14, seed=3, params=PARAMS, device="cpu"),
         tmp_path)
    t_g, t_r = 10000, 2500  # n / Nt = 1/4

    def one_step_from(counts):
        model = models["cosmos"](device="cpu")
        model.load(tmp_path)
        model.init(lr=0.005, nbatch_size=1, fbatch_size=16)
        gen = torch.Generator().manual_seed(0)
        mu = {k: 1e-3 * torch.randn(v.shape, generator=gen, dtype=v.dtype)
              for k, v in model.params.items()}
        nu = {k: torch.full_like(v, 1e-6) for k, v in model.params.items()}
        lead = {k: v[None] for k, v in model.params.items()}
        model.adopt_chain(lead, {k: v[None] for k, v in mu.items()},
                          {k: v[None] for k, v in nu.items()}, 0, t_g)
        if counts is not None:  # the truthful per-row counts
            for k, c in counts.items():
                model.opt_state["count"][k].fill_(c)
        p0 = {k: v.clone() for k, v in model.params.items()}
        model._sparse_step(torch.Generator().manual_seed(7))
        return {k: (model.params[k] - p0[k]).numpy() for k in p0}

    upd_true = one_step_from({"g": t_g, "a": t_r, "af": t_r})
    upd_coerced = one_step_from(None)

    b1, b2 = 0.9, 0.999
    factor = ((1 - b1**t_r) / (1 - b1**t_g)) * np.sqrt((1 - b2**t_g) / (1 - b2**t_r))
    bound = abs(factor - 1.0)
    assert bound < 0.05, f"analytic bound {bound:.3f} not <5% at t_g={t_g}"
    for k in upd_true:
        a, b = upd_true[k], upd_coerced[k]
        moved = np.abs(a) > 0
        if not moved.any():
            continue
        rel = np.abs(b[moved] - a[moved]) / np.abs(a[moved])
        if k in ("gain_loc", "gain_beta", "proximity_loc", "proximity_size",
                 "lamda_loc", "lamda_beta", "pi_mean", "pi_size"):
            assert rel.max() < 1e-6, f"global {k} must be exact"
        else:
            assert rel.max() <= bound * 1.01 + 1e-6, (
                f"{k}: measured {rel.max():.4f} exceeds analytic {bound:.4f}"
            )


@pytest.fixture(scope="module")
def restarts_ws(tmp_path_factory):
    """``fit -R 2 --restart-iter 4 -it 3`` on a 2-AOI, 5-frame workspace
    (tests/test_cli.py:249-279)."""
    ws = tmp_path_factory.mktemp("restarts_cli")
    save(simulate("cosmos", N=2, F=5, C=1, P=14, seed=0, params=PARAMS, device="cpu"), ws)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CI", "true")
        code = cli.main(["--cd", str(ws), "fit", "--model", "cosmos", "-S", "1",
                         "--nbatch-size", "2", "--fbatch-size", "5", "-R", "2",
                         "--restart-iter", "4", "--num-iter", "3", "--cpu", "--no-input"])
    return ws, code


def test_fit_restarts_command_continues_the_winner(restarts_ws):
    ws, code = restarts_ws
    assert code == 0
    meta = json.loads((ws / ".tapqir" / "cosmos_restarts.json").read_text())
    assert set(meta) == {"num_restarts", "restart_iter", "best_chain", "final_losses"}
    assert meta["num_restarts"] == 2 and meta["restart_iter"] == 4
    assert meta["best_chain"] in (0, 1)
    assert len(meta["final_losses"]) == 2 and np.isfinite(meta["final_losses"]).all()
    assert (ws / "cosmos_summary.csv").exists()
    m = models["cosmos"](device="cpu")
    m.load(ws)
    m.init(0.005, nbatch_size=2, fbatch_size=5)
    assert m.iter == 7  # 4 restart steps + 3 continuation steps


def test_jax_stats_reads_a_restarts_workspace(restarts_ws, tmp_path):
    ws = Path(shutil.copytree(restarts_ws[0], tmp_path / "ws"))
    (ws / "cosmos_summary.csv").unlink()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CI", "true")
        result = CliRunner().invoke(jax_app, ["--cd", str(ws), "stats", "--cpu",
                                              "--no-input"])
    assert result.exit_code == 0, result.output + repr(result.exception)
    assert (ws / "cosmos_summary.csv").exists()


@pytest.mark.parametrize("extra, item", [
    (["-R", "2", "--mesh", "auto"], 8),
    (["-R", "2", "--profile", "3", "--mesh", "auto"], 8),
])
def test_restarts_with_unported_options_exit_nonzero(tmp_path, caplog, monkeypatch,
                                                     restarts_ws, extra, item):
    """``--mesh`` (ROADMAP Queue A item 8) is ported, and with ``--cpu`` the
    JAX command ignores it: ``-R 2 --mesh auto --cpu`` runs the
    single-device restarts of ``restarts_ws`` and writes the same selection
    and checkpoint; with ``--profile`` it profiles one device and writes no
    restarts, as without ``--mesh``."""
    monkeypatch.setenv("CI", "true")
    save(simulate("cosmos", N=2, F=5, C=1, P=14, seed=0, params=PARAMS, device="cpu"),
         tmp_path)
    argv = ["--cd", str(tmp_path), "fit", "--model", "cosmos", "-S", "1", "--nbatch-size",
            "2", "--fbatch-size", "5", "--restart-iter", "4", "--num-iter", "3", *extra,
            "--cpu", "--no-input"]
    assert cli.main(argv) == 0
    assert "Mesh" not in caplog.text  # no mesh was started
    run = tmp_path / ".tapqir"
    if "--profile" in extra:
        assert (run / "profile" / "cosmos_trace.json").exists()
        assert not (run / "cosmos_restarts.json").exists()
        return
    ws = restarts_ws[0] / ".tapqir"
    assert (json.loads((run / "cosmos_restarts.json").read_text())
            == json.loads((ws / "cosmos_restarts.json").read_text()))
    with np.load(run / "cosmos_model.tpqr") as got, np.load(ws / "cosmos_model.tpqr") as want:
        for k in want.files:
            if k != "meta":
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
