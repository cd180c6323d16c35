"""Reference fits for the fit-level cross-check of the PyTorch port.

For each model this simulates the dataset that the matching ``check_*`` of
``tests/recovery_driver.py`` fits (``tapqir_tpu.utils.simulate.simulate``
with its parameters, sizes and seed 0), fits the JAX model on it twice with
``init(lr=0.005, nbatch_size=min(N, 10), fbatch_size=min(F, 512))`` and the
check's budget, and writes ``crosscheck_jax_<model>.npz``:

* fit 0 keeps the package's own ``PRNGKey(0)``; fit 1 sets ``model._key =
  jax.random.PRNGKey(1)`` after ``init``, so the two measure the
  reference's own run-to-run spread;
* fit 0 must pass the bounds of ``check_*`` (asserted by running the check
  itself on it), so the golden is a passing reference recovery;
* the file is a ``data.tpqr`` (the keys ``dataset.save`` writes, images as
  the smallest unsigned integer type that holds them), so both packages'
  ``dataset.load`` read it directly, plus for each fit ``fit<i>/<param>/
  {Mean,LL,UL}`` at CI 0.95 of gain, proximity, lamda and pi / init /
  trans / alpha as the model has them, ``fit<i>/mcc`` (``recovery_driver.
  _mcc``), ``fit<i>/steps``, ``fit<i>/loss`` and ``fit<i>/seconds``, and
  the configuration (``config``, JSON) and ``jax_version``.

Run outside pytest (``tests/conftest.py`` forces 8 virtual devices, which
makes these fits several times slower):

    JAX_PLATFORMS=cpu python tests/golden/gen_crosscheck_jax.py [model ...]

Without arguments it fits all three models in turn.
"""

import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))  # tests/, for recovery_driver
sys.path.insert(0, str(HERE.parent.parent))

import jax  # noqa: E402

import recovery_driver  # noqa: E402
from tapqir_tpu.models import models  # noqa: E402
from tapqir_tpu.utils.simulate import simulate  # noqa: E402

CI = 0.95
SUMMARY_PARAMS = ("gain", "proximity", "lamda", "pi", "init", "trans", "alpha")
CHECKS = {
    "cosmos": "check_cosmos",
    "cosmos+hmm": "check_hmm",
    "crosstalk": "check_crosstalk",
}


def golden_path(model_name):
    return HERE / f"crosscheck_jax_{model_name}.npz"


def _fit(name, data, N, F, iters, fit_index, workdir):
    model = models[name]()
    model.data = data
    model.path = Path(workdir) / f"fit{fit_index}"
    model.path.mkdir()
    model.run_path = model.path / ".tapqir"
    model.init(lr=0.005, nbatch_size=min(N, 10), fbatch_size=min(F, 512))
    if fit_index:
        model._key = jax.random.PRNGKey(fit_index)
    t0 = time.perf_counter()
    model.run(iters, progress_bar=lambda it: it)
    return model, time.perf_counter() - t0


def _summary(model, data, prefix):
    model.ci_params = [p for p in model.ci_params if p in SUMMARY_PARAMS]
    ci = model.compute_params(CI)
    out = {}
    for param in model.ci_params:
        for stat in ("Mean", "LL", "UL"):
            out[f"{prefix}/{param}/{stat}"] = np.asarray(ci[param][stat], np.float64)
    out[f"{prefix}/mcc"] = np.float64(recovery_driver._mcc(model, data))
    out[f"{prefix}/steps"] = np.int64(model.iter)
    losses = model._rolling.get("-ELBO", [])
    out[f"{prefix}/loss"] = np.float64(losses[-1] if len(losses) else np.nan)
    return out


def _dataset_payload(data):
    images = np.asarray(data.images)
    for dtype in (np.uint8, np.uint16, np.uint32):
        if images.min() >= 0 and images.max() <= np.iinfo(dtype).max:
            break
    packed = images.astype(dtype)
    if not np.array_equal(packed.astype(np.float32), images):
        raise ValueError("the simulated images are not integers")
    return {
        "images": packed,
        "xy": np.asarray(data.xy),
        "is_ontarget": np.asarray(data.is_ontarget),
        "mask": np.asarray(data.mask),
        "labels": np.asarray(data.labels),
        "offset_samples": np.asarray(data.offset.samples),
        "offset_weights": np.asarray(data.offset.weights),
        "name": np.asarray(data.name),
        "channels": np.asarray(list(data.channels)),
    }


def generate(model_name):
    with tempfile.TemporaryDirectory(prefix="crosscheck_jax_") as workdir:
        _generate(model_name, workdir)


def _generate(model_name, workdir):
    config = {}
    fits = []

    def fit_and_record(name, sim_params, N, F, C, seed=0, iters=None):
        # stands in for recovery_driver._fit: the check passes its own
        # parameters, sizes and budget, and its bounds then run on fit 0
        iters = iters or recovery_driver.ITERS
        config.update(model=name, params=sim_params, N=N, F=F, C=C, P=14,
                      seed=seed, iters=iters, lr=0.005,
                      nbatch_size=min(N, 10), fbatch_size=min(F, 512), CI=CI)
        data = simulate(name, N=N, F=F, C=C, P=14, seed=seed, params=sim_params)
        model, seconds = _fit(name, data, N, F, iters, 0, workdir)
        fits.append((model, seconds))
        return model, data

    original = recovery_driver._fit
    recovery_driver._fit = fit_and_record
    try:
        getattr(recovery_driver, CHECKS[model_name])()
    finally:
        recovery_driver._fit = original
    print(f"[{model_name}] fit 0 passes {CHECKS[model_name]} "
          f"({fits[0][1]:.1f} s)", flush=True)

    data = simulate(model_name, N=config["N"], F=config["F"], C=config["C"],
                    P=14, seed=config["seed"], params=config["params"])
    model1, seconds1 = _fit(model_name, data, config["N"], config["F"],
                            config["iters"], 1, workdir)
    fits.append((model1, seconds1))
    print(f"[{model_name}] fit 1 done ({seconds1:.1f} s)", flush=True)

    payload = _dataset_payload(data)
    for i, (model, seconds) in enumerate(fits):
        payload.update(_summary(model, data, f"fit{i}"))
        payload[f"fit{i}/seconds"] = np.float64(seconds)
    payload["config"] = np.asarray(json.dumps(config))
    payload["jax_version"] = np.asarray(jax.__version__)
    with open(golden_path(model_name), "wb") as f:
        np.savez_compressed(f, **payload)
    print(f"[{model_name}] wrote {golden_path(model_name).name} "
          f"({golden_path(model_name).stat().st_size} bytes); "
          + ", ".join(f"fit{i} MCC {float(payload[f'fit{i}/mcc']):.4f}"
                      for i in range(len(fits))), flush=True)


if __name__ == "__main__":
    for name in sys.argv[1:] or list(CHECKS):
        generate(name)
