"""The port's fit loop on the CPU: ``checkpoint_interval``,
``full_checkpoint_every`` and ``progress_bar`` of ``Model.run``, and the
port's own fixed-seed trajectory goldens (``tests/golden/trajectory_torch_
cosmos.npz``, ``trajectory_torch_cosmos+hmm.npz`` and
``trajectory_torch_crosstalk.npz``, checked through
``tests/golden/trajectory.py``) from the fits of the JAX package's cosmos,
hmm and crosstalk tests - 200 full-batch steps with a checkpoint every 50 -
on numpy-seeded data (two dyes in two channels for crosstalk).

Regenerate the goldens deliberately after an intended change of the
estimator or of the sampling:
``TAPQIR_REGEN_GOLDENS=1 python -m pytest tests/test_torch_trajectory.py``."""

import json
import logging

import numpy as np
import pytest
import torch

from _torch_port_data import numpy_crosstalk_dataset, numpy_dataset
from tapqir_tpu_torch.models import models
from tapqir_tpu_torch.utils.dataset import CosmosDataset, OffsetData, save

torch.set_num_threads(1)


def _fit(tmp_path_factory, name, Nt, F, num_iter=200, dataset=numpy_dataset):
    ws = tmp_path_factory.mktemp(name.replace("+", "_"))
    save(dataset(CosmosDataset, OffsetData, Nt=Nt, F=F, seed=0), ws)
    model = models[name](device="cpu")
    model.load(ws)
    model.init(lr=0.005, nbatch_size=Nt, fbatch_size=F)
    model.checkpoint_interval = 50  # denser rolling points, shorter fit
    model.run(num_iter, progress_bar=lambda it: it)
    return model


@pytest.fixture(scope="module")
def fitted_cosmos(tmp_path_factory):
    return _fit(tmp_path_factory, "cosmos", Nt=4, F=40)


@pytest.fixture(scope="module")
def fitted_hmm(tmp_path_factory):
    return _fit(tmp_path_factory, "cosmos+hmm", Nt=4, F=30)


@pytest.fixture(scope="module")
def fitted_crosstalk(tmp_path_factory):
    return _fit(tmp_path_factory, "crosstalk", Nt=4, F=20, dataset=numpy_crosstalk_dataset)


def _metrics_iters(model):
    rows = (model.run_path / "logs" / model.name / "metrics.csv").read_text().splitlines()
    return [int(r.split(",")[0]) for r in rows[1:]]


def _checkpoint_iter(model):
    with np.load(model._checkpoint_path) as z:
        return json.loads(bytes(z["meta"]).decode())["iter"]


@pytest.mark.parametrize("fixture", ["fitted_cosmos", "fitted_hmm", "fitted_crosstalk"])
def test_checkpoint_interval_sets_the_rolling_points(fixture, request):
    model = request.getfixturevalue(fixture)
    assert model.iter == 200
    assert len(model._rolling["-ELBO"]) == 4  # one per 50 steps
    assert _metrics_iters(model) == [50, 100, 150, 200]
    assert _checkpoint_iter(model) == 200
    losses = model._rolling["-ELBO"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("fixture", ["fitted_cosmos", "fitted_hmm", "fitted_crosstalk"])
def test_trajectory_golden(fixture, request, trajectory_golden_check):
    model = request.getfixturevalue(fixture)
    trajectory_golden_check(model, f"torch_{model.name}")


@pytest.fixture
def small(tmp_path):
    save(numpy_dataset(CosmosDataset, OffsetData, Nt=4, F=6, seed=1), tmp_path)
    model = models["cosmos"](device="cpu")
    model.load(tmp_path)
    model.init(lr=0.005, nbatch_size=2, fbatch_size=4)
    return model


def test_full_checkpoint_every_skips_full_writes(small, monkeypatch):
    """Five checkpoints of 2 steps with ``full_checkpoint_every = 2``: the
    full state is written at the 2nd and 4th and at the last; every one
    extends the rolling series and logs its metrics."""
    written = []
    orig = small._write_checkpoint

    def counted():
        written.append(small.iter)
        orig()

    monkeypatch.setattr(small, "_write_checkpoint", counted)
    small.checkpoint_interval, small.full_checkpoint_every = 2, 2
    small.run(10)
    assert written == [4, 8, 10]
    assert len(small._rolling["-ELBO"]) == 5
    assert _metrics_iters(small) == [2, 4, 6, 8, 10]
    assert _checkpoint_iter(small) == 10
    # a light checkpoint still rejects non-finite parameters
    small.params["gain_loc"].fill_(float("nan"))
    with pytest.raises(ValueError, match="NaN values in gain_loc"):
        small.save_checkpoint(save_full=False)


def test_progress_bar_is_advanced_num_iter_times(small, caplog):
    caplog.set_level(logging.INFO, logger="tapqir_tpu_torch")

    class Bar:
        def __init__(self, it):
            self.it, self.steps, self.postfix = it, 0, []

        def __iter__(self):
            for i in self.it:
                self.steps += 1
                yield i

        def set_postfix(self, d):
            self.postfix.append(d)

    bars = []

    def progress_bar(it):
        bars.append(Bar(it))
        return bars[-1]

    small.checkpoint_interval = 3
    small.run(7, progress_bar=progress_bar)
    (bar,) = bars
    assert list(bar.it) == list(range(7)) and bar.steps == 7
    assert [set(d) for d in bar.postfix] == [{"-ELBO"}] * 3
    assert "Iteration #3: -ELBO" not in caplog.text  # the bar replaces the log lines
    small.run(3)  # no bar: one INFO line per checkpoint
    assert f"Iteration #10: -ELBO {small.iter_loss:.1f}" in caplog.text
