"""The port's mesh (tapqir_tpu_torch/parallel/sharding.py) against the JAX
package's ``shard_map`` mesh.

The JAX side runs here on the 8 virtual CPU devices of tests/conftest.py;
the port's side runs in gloo ranks on the CPU, one process per shard,
spawned once for this module (``_torch_mesh_worker.run_cases``). Both take
the same numpy inputs in float64, and every rank of the port takes the
batch and the packed standard-Gamma draws that the JAX shard of its (aoi,
frame) index drew from its folded keys, so the comparisons are exact at
rtol 1e-6 (gradients with an absolute floor of 1e-6 times the array's
largest magnitude, for entries that are zero up to round-off):

* the loss and every gradient of one cosmos step on a 4x2 mesh against
  ``make_sharded_grads_fn``;
* the sharded posterior marginals on 4x2 against ``make_sharded_probs_fn``
  with each block's particle draws;
* the frame-sharded prefix scan and its gradient on 1x8 against the JAX
  package's inside ``shard_map``;
* the gather and the shift by one rank, values and gradients, against
  their one-process reference;

and a rank that raises ends the launch with its traceback, with no hang.
The hmm, crosstalk and prime-Nt cases are in
tests/test_torch_sharding_models.py, restarts, checkpoints, the NaN guard
and the command line in tests/test_torch_sharding_fit.py.
"""

import importlib
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import _torch_mesh_worker as worker
from _torch_port_data import (
    assert_close_scaled,
    jax_particle_draws,
    numpy_dataset,
    perturbed_params,
)
from tapqir_tpu.models import models as jax_models
from tapqir_tpu.ops.scan import sharded_cumulative_logmatmulexp as jax_sharded_scan
from tapqir_tpu.parallel.sharding import (
    data_partition as jax_data_partition,
    make_mesh as jax_make_mesh,
    make_sharded_grads_fn,
    make_sharded_probs_fn,
    shard_params_and_data,
)
from tapqir_tpu.utils.dataset import CosmosDataset as JaxDataset
from tapqir_tpu.utils.dataset import OffsetData as JaxOffset
from tapqir_tpu_torch.parallel.sharding import MeshError, launch, make_mesh
from tapqir_tpu_torch.utils.dataset import CosmosDataset, OffsetData

torch.set_num_threads(1)
RTOL = 1e-6
jax_cosmos_module = importlib.import_module("tapqir_tpu.models.cosmos")


@pytest.fixture(scope="module", autouse=True)
def _restore_x64_after_module():
    """The float64 JAX models here turn x64 on; put the flag back when the
    module is done so that it cannot leak into float32 fits."""
    old = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", old)


def block(arr, spec, shape, ai, fi):
    """Shard (ai, fi)'s block of ``arr`` under the axes ``spec`` of a mesh
    of ``shape`` (n_aoi, n_frame), as ``shard_map`` slices it."""
    idx = []
    for d, entry in enumerate(spec):
        n = {"aoi": shape[0], "frame": shape[1]}.get(entry)
        if n is None:
            idx.append(slice(None))
            continue
        b = arr.shape[d] // n
        i = ai if entry == "aoi" else fi
        idx.append(slice(i * b, (i + 1) * b))
    return arr[tuple(idx)]


def model_pair(name, Nt, F, nbatch, fbatch, seed=3, factored=False, dataset=numpy_dataset,
               jax_name=None):
    """The JAX model (float64, perturbed parameters) and the port's spec of
    the same model: dataset, batch sizes, route and parameters."""
    jax.config.update("jax_enable_x64", True)  # restored by the module fixture
    jm = jax_models[jax_name or name](dtype="double")
    jm.data = dataset(JaxDataset, JaxOffset, Nt=Nt, F=F, seed=seed)
    jm.nbatch_size, jm.fbatch_size = nbatch, fbatch
    jm.use_factored = factored
    jm.init_parameters()
    jm._data_dev = jm._data_device_arrays()
    p_np = perturbed_params({k: np.asarray(v) for k, v in jm.params.items()})
    jm.params = {k: jnp.asarray(v) for k, v in p_np.items()}
    spec = {"model": name, "data": dataset(CosmosDataset, OffsetData, Nt=Nt, F=F, seed=seed),
            "nbatch": nbatch, "fbatch": fbatch, "factored": factored, "params": p_np}
    return jm, spec


def shard_recorder(jm, module, n_shards, frame_shards, monkeypatch):
    """A jitted (local params, local data, shard key, row key) -> (ndx,
    fidx, packed draws) of the JAX shard's ELBO; the likelihood is dead
    code there, so XLA drops it."""
    orig = module.std_gamma_sample_packed

    def fn(pl, dl, kk, kn):
        rec = []

        def recording(k, concs):
            out = orig(k, concs)
            rec.append(out)
            return out

        monkeypatch.setattr(module, "std_gamma_sample_packed", recording)
        try:
            _, (ndx, fidx) = jm.elbo(pl, kk, dl, n_shards=n_shards,
                                     frame_shards=frame_shards, key_ndx=kn,
                                     return_batch=True)
        finally:
            monkeypatch.setattr(module, "std_gamma_sample_packed", orig)
        flat = jnp.concatenate([jnp.reshape(a, (-1,)) for a in rec[0]])
        return ndx, fidx, flat

    return jax.jit(fn)


def shard_inputs(jm, params, key, shape, module, monkeypatch, fold=lambda k: k):
    """Per rank (row-major over the mesh of ``shape``), the batch (ndx,
    fidx or None, f) and packed draws the JAX sharded step draws from
    ``fold_in(key, shard_id)`` and the row key ``fold_in(key, aoi_index)``
    with ``params`` (both keys passed through ``fold``: a restart chain's
    ``fold_in(., r)``)."""
    specs, dspecs = jm.param_partition(), jax_data_partition()
    rec = shard_recorder(jm, module, shape[0] * shape[1], shape[1], monkeypatch)
    batches, draws = [], []
    for ai in range(shape[0]):
        kn = jax.random.fold_in(key, ai)
        for fi in range(shape[1]):
            kk = jax.random.fold_in(key, ai * shape[1] + fi)
            pl = {k: block(v, specs[k], shape, ai, fi) for k, v in params.items()}
            dl = {k: block(v, dspecs[k], shape, ai, fi) for k, v in jm._data_dev.items()}
            ndx, fidx, flat = rec(pl, dl, fold(kk), fold(kn))
            F_l = dl["xy"].shape[1]
            f = min(jm.fbatch_size, F_l)
            fidx = None if fidx is None or f == F_l else np.asarray(fidx)
            batches.append((np.asarray(ndx), fidx, f))
            draws.append(np.asarray(flat))
    return batches, draws


def jax_sharded_step(jm, shape, key):
    """The JAX mesh step's loss and full gradients."""
    mesh = jax_make_mesh(*shape)
    params_sh, data_sh = shard_params_and_data(mesh, jm.params, jm.param_partition(),
                                               jm._data_dev)
    loss, grads = jax.jit(make_sharded_grads_fn(jm, mesh))(params_sh, key, data_sh)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def assert_step_matches(got, want_loss, want_grads):
    np.testing.assert_allclose(got["loss"], want_loss, rtol=RTOL)
    assert set(got["grads"]) == set(want_grads)
    for k, g in want_grads.items():
        assert_close_scaled(got["grads"][k], g, f"gradient {k}", RTOL)


COSMOS_SHAPE = (4, 2)
NUM_PARTICLES = 3


@pytest.fixture(scope="module")
def mesh_run():
    """Every case of this module's 8-rank launch and its JAX references."""
    mp = pytest.MonkeyPatch()
    try:
        yield _mesh_run(mp)
    finally:
        mp.undo()


def _mesh_run(monkeypatch):
    cases, want = [], {}

    # one cosmos step on 4x2: 2 of 2 local AOIs, 2 of 4 local frames
    jm, spec = model_pair("cosmos", Nt=8, F=8, nbatch=2, fbatch=2)
    key = jax.random.PRNGKey(7)
    batches, draws = shard_inputs(jm, jm.params, key, COSMOS_SHAPE, jax_cosmos_module,
                                  monkeypatch)
    want["step"] = jax_sharded_step(jm, COSMOS_SHAPE, key)
    cases.append({"kind": "step", "shape": COSMOS_SHAPE, "spec": spec, "batches": batches,
                  "draws": draws})

    # the posterior marginals, block by block, with each block's draws
    pkey = jax.random.PRNGKey(5)
    mesh = jax_make_mesh(*COSMOS_SHAPE)
    params_sh, data_sh = shard_params_and_data(mesh, jm.params, jm.param_partition(),
                                               jm._data_dev)
    z, th = jax.jit(make_sharded_probs_fn(jm, mesh, num_particles=NUM_PARTICLES))(
        params_sh, pkey, data_sh)
    want["probs"] = (np.asarray(z), np.asarray(th))
    pc = {k: jm._transforms[k](v) for k, v in jm.params.items()}
    specs = jm.param_partition()
    bdraws = []
    for ai in range(COSMOS_SHAPE[0]):
        for fi in range(COSMOS_SHAPE[1]):
            pl = {k: block(v, specs[k], COSMOS_SHAPE, ai, fi) for k, v in pc.items()}
            kk = jax.random.fold_in(pkey, ai * COSMOS_SHAPE[1] + fi)
            bdraws.append(jax_particle_draws(jm, pl, kk, jnp.arange(2), jnp.arange(4),
                                             NUM_PARTICLES))
    cases.append({"kind": "probs", "shape": COSMOS_SHAPE, "spec": spec, "draws": bdraws,
                  "num_particles": NUM_PARTICLES})

    # the frame-sharded scan on 1x8 (n=3, F=16, S=2) and its gradient
    rng = np.random.default_rng(0)
    logA = np.log(rng.dirichlet(np.ones(2), size=(3, 16, 2)))
    weights = rng.standard_normal(logA.shape)
    smesh = jax_make_mesh(1, 8)
    spec4 = P(None, "frame", None, None)

    def body(x, w):
        out = jax_sharded_scan(x, 1, "frame")
        return out, jax.lax.psum((out * w).sum(), "frame")

    sharded = jax.shard_map(body, mesh=smesh, in_specs=(spec4, spec4),
                            out_specs=(spec4, P()))
    out = jax.jit(lambda x, w: sharded(x, w)[0])(logA, weights)
    grad = jax.jit(jax.grad(lambda x, w: sharded(x, w)[1]))(logA, weights)
    want["scan"] = (np.asarray(out), np.asarray(grad))
    cases.append({"kind": "scan", "shape": (1, 8), "log_mats": logA, "weights": weights})

    # the collectives against their one-process reference
    cweights = rng.standard_normal((8, 9, 3))
    want["collectives"] = cweights
    cases.append({"kind": "collectives", "shape": (2, 4), "weights": cweights})

    got = launch(make_mesh(4, 2, "cpu"), worker.run_cases, cases, timeout=120)
    return dict(zip([c["kind"] for c in cases], got)), want


def test_cosmos_step_on_4x2_matches_jax(mesh_run):
    got, want = mesh_run
    assert got["step"]["padded"] == 0
    assert_step_matches(got["step"], *want["step"])


def test_sharded_posteriors_match_jax_blocks(mesh_run):
    got, want = mesh_run
    z, th = want["probs"]
    assert got["probs"]["z"].shape == z.shape == (8, 8, 1, 2)
    assert got["probs"]["theta"].shape == th.shape
    assert_close_scaled(got["probs"]["z"], z, "z_probs", RTOL)
    assert_close_scaled(got["probs"]["theta"], th, "theta_probs", RTOL)
    assert (got["probs"]["z"][4:] == 0).all()  # off-target AOIs are not scored


def test_sharded_scan_and_its_gradient_match_jax(mesh_run):
    got, want = mesh_run
    out, grad = want["scan"]
    np.testing.assert_allclose(got["scan"]["out"], out, rtol=RTOL)
    assert_close_scaled(got["scan"]["grad"], grad, "scan gradient", RTOL)


def test_collectives_and_their_gradients(mesh_run):
    """Rank r holds x_r = arange(3) + 10 r and scores sum_s w_r[s] *
    gather(x)[s] + w_r[-1] * shift(x): the gradient of x_s is the sum over
    the ranks r of w_r[s], plus w_{s+1}[-1] (rank s + 1 takes x_s)."""
    got, want = mesh_run
    c, w = got["collectives"], want["collectives"]
    x = np.arange(3)[None] + 10.0 * np.arange(8)[:, None]
    np.testing.assert_array_equal(c["gather"], x)
    np.testing.assert_array_equal(c["shift"], np.roll(x, 1, axis=0))
    want = w[:, :8].sum(0) + np.roll(w[:, 8], -1, axis=0)
    np.testing.assert_allclose(c["grad"], want, rtol=1e-12)


def test_a_raising_rank_fails_the_launch_without_a_hang():
    t0 = time.perf_counter()
    with pytest.raises(MeshError, match="rank 1 fails on purpose"):
        launch(make_mesh(2, 1, "cpu"), worker.run_cases,
               [{"kind": "raise", "shape": (2, 1)}], timeout=30)
    assert time.perf_counter() - t0 < 30


def test_make_mesh_lays_out_devices_and_chooses_the_backend():
    mesh = make_mesh(2, 2, "cpu")
    assert mesh.size == 4 and mesh.devices == ["cpu"] * 4 and mesh.backend == "gloo"
    assert make_mesh(2, 2, ["cuda:0"] * 4).backend == "gloo"  # a shared card
    assert make_mesh(2, 1, ["cuda:0", "cuda:1"]).backend == "nccl"
    with pytest.raises(AssertionError, match="need 4 devices, have 2"):
        make_mesh(2, 2, ["cuda:0", "cuda:1"])


def test_kernel_launch_refuses_tensors_on_another_card(monkeypatch):
    """The library launches on the runtime's current device, so the launcher
    raises for tensors on any other card instead of launching there, before
    the library is built."""
    from tapqir_tpu_torch.ops import offset_gamma as og

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(og.library, "get", lambda: pytest.fail("built the library"))
    like = types.SimpleNamespace(device=torch.device("cuda:1"), dtype=torch.float32)
    before = og.summed_stats.launches
    with pytest.raises(RuntimeError, match="current device is cuda:0"):
        og.summed_stats.function(like)
    assert og.summed_stats.launches == before
