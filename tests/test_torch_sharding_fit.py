"""Fitting on the port's mesh against the JAX package's (set-up as in
tests/test_torch_sharding.py: one 4-rank gloo launch on the CPU for this
module, float64, rtol 1e-6):

* ``fit_restarts_sharded`` on 2x2 against the JAX one: its perturbed
  init, and every chain's batch and draws on every rank, fed to the port;
  the losses, the best chain, the winner's parameters and the fresh Adam
  state it continues with;
* the checkpoint round trip of a prime-Nt mesh fit (``use_mesh`` ->
  ``run``): written at the real Nt and read by the JAX package's
  ``load_checkpoint``, the posteriors unpadded, a resumed mesh fit that
  pads again;
* the NaN guard on the mesh: one rank's NaN reloads and reseeds every rank
  alike;

and the command line's mesh path on CPU ranks: ``fit --mesh 2x1`` then
``stats --mesh 2x1`` in a workspace the JAX command line reads.
"""

import importlib
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from click.testing import CliRunner

import _torch_mesh_worker as worker
from _torch_port_data import assert_close_scaled, numpy_dataset
from tapqir_tpu.main import app as jax_app
from tapqir_tpu.models import models as jax_models
from tapqir_tpu.parallel.sharding import fit_restarts_sharded as jax_fit_restarts_sharded
from tapqir_tpu.parallel.sharding import make_mesh as jax_make_mesh
from tapqir_tpu_torch import main as cli
from tapqir_tpu_torch.parallel.sharding import launch, make_mesh
from tapqir_tpu_torch.utils.dataset import CosmosDataset, OffsetData, save
from test_torch_sharding import model_pair, shard_inputs

torch.set_num_threads(1)
RTOL = 1e-6
jax_cosmos_module = importlib.import_module("tapqir_tpu.models.cosmos")
RESTART_R = 3


@pytest.fixture(scope="module", autouse=True)
def _restore_x64_after_module():
    """The float64 JAX models here turn x64 on; put the flag back when the
    module is done so that it cannot leak into float32 fits."""
    old = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", old)


def restart_case(monkeypatch):
    """JAX ``fit_restarts_sharded`` (R chains, one step) on 2x2 and the
    port's case: the same perturbed init (its keys: sharding.py:241-262)
    and, per rank, every chain's batch and draws, from the keys of the JAX
    step (``fold_in`` of the shard's and the row's key by the chain)."""
    shape, R = (2, 2), RESTART_R
    jm, spec = model_pair("cosmos", Nt=4, F=8, nbatch=2, fbatch=2, seed=5)
    jm.lr = 0.005
    jm.tx = optax.adam(0.005, b1=0.9, b2=0.999, eps=1e-8)
    jm.opt_state = jm.tx.init(jm.params)
    jm.iter = 0
    k_perturb, k_run = jax.random.split(jax.random.PRNGKey(0))
    init = {}
    for name, v in jm.params.items():
        v = np.asarray(v)
        noise = np.array(0.1 * jax.random.normal(
            jax.random.fold_in(k_perturb, zlib.crc32(name.encode()) % (2**31)),
            (R,) + v.shape, v.dtype))
        noise[0] = 0.0
        init[name] = np.broadcast_to(v, (R,) + v.shape) + noise
    _, sub = jax.random.split(k_run)
    (k,) = jax.random.split(sub, 1)  # the chunk's one step
    chains = [shard_inputs(jm, {n: jnp.asarray(v[r]) for n, v in init.items()}, k, shape,
                           jax_cosmos_module, monkeypatch,
                           fold=lambda key, r=r: jax.random.fold_in(key, r))
              for r in range(R)]
    ranks = range(shape[0] * shape[1])
    step = {
        "batches": [(np.stack([c[0][i][0] for c in chains]),
                     np.stack([c[0][i][1] for c in chains]), chains[0][0][i][2])
                    for i in ranks],
        "draws": [np.stack([c[1][i] for c in chains]) for i in ranks],
    }
    losses, best = jax_fit_restarts_sharded(jm, jax_make_mesh(*shape), num_restarts=R,
                                            num_iter=1, perturb=0.1, chunk=1)
    case = {"kind": "restarts", "shape": shape, "spec": spec, "R": R, "chunk": 1,
            "init": init, "steps": [step], "name": "restarts"}
    return case, (np.asarray(losses), best, jm)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        cases, want = [], {}
        c, want["restarts"] = restart_case(mp)
        cases.append(c)
        path = tmp_path_factory.mktemp("mesh_ckpt")
        save(numpy_dataset(CosmosDataset, OffsetData, Nt=7, F=4, seed=1), path)
        cases.append({"kind": "checkpoint", "shape": (4, 1), "path": str(path),
                      "name": "checkpoint"})
        want["checkpoint"] = path
        path = tmp_path_factory.mktemp("mesh_nan")
        save(numpy_dataset(CosmosDataset, OffsetData, Nt=8, F=4, seed=3), path)
        cases.append({"kind": "nan_reload", "shape": (2, 2), "path": str(path),
                      "name": "nan_reload"})
        got = launch(make_mesh(2, 2, "cpu"), worker.run_cases, cases, timeout=120)
        yield dict(zip([c["name"] for c in cases], got)), want
    finally:
        mp.undo()


def test_fit_restarts_sharded_matches_jax(mesh_run):
    got, want = mesh_run
    g = got["restarts"]
    losses, best, jm = want["restarts"]
    assert g["losses"].shape == (RESTART_R, 1)
    np.testing.assert_allclose(g["losses"], losses, rtol=RTOL)
    assert g["best"] == best
    for name, v in jm.params.items():
        assert_close_scaled(g["params"][name], np.asarray(v), f"param {name}", RTOL)
        # the winner continues with a fresh Adam state, as in the JAX package
        assert not g["mu"][name].any() and not g["nu"][name].any()
    assert g["count"] == int(np.asarray(jm.opt_state[0].count)) == 0
    assert g["iter"] == jm.iter == 1
    np.testing.assert_allclose(g["iter_loss"], jm.iter_loss, rtol=RTOL)


def test_mesh_checkpoint_round_trip_with_a_prime_nt(mesh_run):
    got, want = mesh_run
    g, path = got["checkpoint"], want["checkpoint"]
    assert g["padded_aois"] == g["resumed_padded_aois"] == 8
    assert g["local_b_loc"][0] == 2
    assert g["z"].shape[0] == 7 and g["theta"].shape[1] == 7
    assert g["resumed_iter"] == 4 and g["final_iter"] == 6
    with np.load(path / ".tapqir" / "cosmos_model.tpqr") as z:
        assert z["p::b_loc"].shape[0] == 7 and z["mu::h_loc"].shape[1] == 7
        assert int(z["count"]) == 6
    jm = jax_models["cosmos"]()
    jm.load(path)
    jm.init(lr=0.005, nbatch_size=2, fbatch_size=4)
    assert jm.iter == 6 and jm.params["b_loc"].shape[0] == 7


def test_nan_guard_reloads_and_reseeds_every_rank_alike(mesh_run):
    """A NaN in one rank's block fails the step on every rank (the loss is
    summed over the mesh): all reload the checkpoint, pad and shard it
    again, take the first rank's new seed and finish the run."""
    got, _ = mesh_run
    g = got["nan_reload"]
    assert g["iter"] == 4 and g["finite"] and g["local_b_loc"][0] == 4
    assert len(set(g["seeds"].ravel().tolist())) == 1


def test_fit_and_stats_on_a_mesh_through_the_command_line(tmp_path, monkeypatch):
    """With two cards counted and the mesh's devices the CPU, ``fit
    --mesh 2x1`` trains on the mesh and writes the files of a single-device
    fit, ``stats --mesh 2x1`` shards the posterior marginals, and the JAX
    command line reads the workspace."""
    save(numpy_dataset(CosmosDataset, OffsetData, Nt=5, F=4, seed=2), tmp_path)
    monkeypatch.setenv("CI", "true")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(cli, "make_mesh", lambda n_aoi, n_frame=1: make_mesh(n_aoi, n_frame,
                                                                            "cpu"))
    args = ["--cd", str(tmp_path)]
    assert cli.main([*args, "fit", "--mesh", "2x1", "-n", "2", "-f", "4", "-it", "2",
                     "--no-input"]) == 0
    ckpt = tmp_path / ".tapqir" / "cosmos_model.tpqr"
    with np.load(ckpt) as z:
        assert z["p::b_loc"].shape[0] == 5 and int(z["count"]) == 2
    for name in ("cosmos_params.tpqr", "cosmos_summary.csv"):
        assert (tmp_path / name).exists()
    with np.load(tmp_path / "cosmos_params.tpqr") as z:
        fit_z = z["z_probs"]
    assert fit_z.shape == (5, 4, 1, 2)
    (tmp_path / "cosmos_params.tpqr").unlink()
    assert cli.main([*args, "stats", "--mesh", "2x1", "-n", "2", "-f", "4",
                     "--no-input"]) == 0
    with np.load(tmp_path / "cosmos_params.tpqr") as z:
        np.testing.assert_array_equal(z["z_probs"], fit_z)  # the same particles
    result = CliRunner().invoke(jax_app, [*args, "stats", "--cpu", "--no-input"])
    assert result.exit_code == 0, result.output + repr(result.exception)
