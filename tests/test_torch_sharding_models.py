"""The port's mesh for the other models and paths, against the JAX
package's ``shard_map`` mesh (see tests/test_torch_sharding.py for the
set-up: one 4-rank gloo launch on the CPU for this module, the JAX side on
the virtual CPU devices, float64, each rank fed its JAX shard's batch and
packed draws, rtol 1e-6):

* a prime AOI count (Nt = 7 on 4x1, padded with a masked dead row): the
  loss and every gradient, and the dead row's gradients exactly 0;
* crosstalk on 2x2, dense and factored;
* cosmos+hmm on a 2x2 mesh with the frames sharded: the sharded chain
  scan, the boundary pair shifted by one shard and the start scored on the
  first frame shard only.

Restarts and checkpoints on the mesh: tests/test_torch_sharding_restarts.py.
"""

import importlib

import jax
import numpy as np
import optax
import pytest
import torch

import _torch_mesh_worker as worker
from _torch_port_data import numpy_crosstalk_dataset
from tapqir_tpu.parallel.sharding import make_mesh as jax_make_mesh
from tapqir_tpu_torch.parallel.sharding import launch, make_mesh
from test_torch_sharding import assert_step_matches, jax_sharded_step, model_pair, shard_inputs

torch.set_num_threads(1)
RTOL = 1e-6
jax_cosmos_module = importlib.import_module("tapqir_tpu.models.cosmos")
jax_hmm_module = importlib.import_module("tapqir_tpu.models.hmm")


@pytest.fixture(scope="module", autouse=True)
def _restore_x64_after_module():
    """The float64 JAX models here turn x64 on; put the flag back when the
    module is done so that it cannot leak into float32 fits."""
    old = jax.config.jax_enable_x64
    yield
    jax.config.update("jax_enable_x64", old)


def step_case(jm, spec, shape, key, module, monkeypatch):
    batches, draws = shard_inputs(jm, jm.params, key, shape, module, monkeypatch)
    case = {"kind": "step", "shape": shape, "spec": spec, "batches": batches, "draws": draws}
    return case, jax_sharded_step(jm, shape, key)


@pytest.fixture(scope="module")
def mesh_run():
    mp = pytest.MonkeyPatch()
    try:
        yield _mesh_run(mp)
    finally:
        mp.undo()


def _mesh_run(monkeypatch):
    cases, want = [], {}

    # a prime AOI count: 7 AOIs on 4 AOI shards, one masked dead row
    jm, spec = model_pair("cosmos", Nt=7, F=4, nbatch=2, fbatch=4, seed=4)
    jm.tx = optax.adam(0.005)
    jm.opt_state = jm._init_opt_state()
    jm.pad_for_mesh(jax_make_mesh(4, 1))
    c, want["prime"] = step_case(jm, spec, (4, 1), jax.random.PRNGKey(3),
                                 jax_cosmos_module, monkeypatch)
    cases.append(dict(c, name="prime"))

    # crosstalk on 2x2, dense and factored
    for factored in (False, True):
        jm, spec = model_pair("crosstalk", Nt=4, F=6, nbatch=2, fbatch=2, seed=6,
                              factored=factored, dataset=numpy_crosstalk_dataset)
        label = "crosstalk-factored" if factored else "crosstalk"
        c, want[label] = step_case(jm, spec, (2, 2), jax.random.PRNGKey(11),
                                   jax_cosmos_module, monkeypatch)
        cases.append(dict(c, name=label))

    # cosmos+hmm with the frames sharded: 2 AOIs x 4 frames per rank
    jm, spec = model_pair("cosmos+hmm", Nt=4, F=8, nbatch=2, fbatch=8, seed=7)
    c, want["hmm"] = step_case(jm, spec, (2, 2), jax.random.PRNGKey(2), jax_hmm_module,
                               monkeypatch)
    cases.append(dict(c, name="hmm"))

    got = launch(make_mesh(2, 2, "cpu"), worker.run_cases, cases, timeout=120)
    return dict(zip([c["name"] for c in cases], got)), want


def test_prime_nt_on_4x1_matches_jax_and_dead_rows_get_no_gradient(mesh_run):
    got, want = mesh_run
    g = got["prime"]
    assert g["padded"] == 1 and g["grads"]["b_loc"].shape[0] == 8
    assert_step_matches(g, *want["prime"])
    for name, ax in (("b_loc", 0), ("h_loc", 1), ("background_mean_loc", 0),
                     ("m_probs", 1)):
        np.testing.assert_array_equal(np.take(g["grads"][name], [7], ax), 0.0, err_msg=name)


@pytest.mark.parametrize("route", ["crosstalk", "crosstalk-factored"])
def test_crosstalk_step_on_2x2_matches_jax(mesh_run, route):
    got, want = mesh_run
    assert "alpha_mean" in got[route]["grads"]
    assert_step_matches(got[route], *want[route])


def test_hmm_step_with_sharded_frames_matches_jax(mesh_run):
    got, want = mesh_run
    assert got["hmm"]["grads"]["z_trans"].shape[:2] == (4, 8)
    assert_step_matches(got["hmm"], *want["hmm"])
