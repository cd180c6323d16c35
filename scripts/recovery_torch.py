#!/usr/bin/env python3
"""Parameter recovery of the PyTorch port's fits on a CUDA card, held against
the JAX package's own fits of the same data: the port's counterparts of
``check_cosmos``, ``check_hmm`` and ``check_crosstalk`` in
tests/recovery_driver.py, with the fit-level cross-check beside them.

Each model fits the dataset saved in ``tests/golden/crosscheck_jax_<model>.npz``
(written by ``tests/golden/gen_crosscheck_jax.py``: the JAX simulator's data
for the check, seed 0, and two JAX fits of it), with ``init(lr=0.005,
nbatch_size=min(N, 10), fbatch_size=min(F, 512))`` and the check's budget:

* ``--model cosmos`` (the default): N=20 AOIs (10 on target), F=80, C=1,
  pi 0.15, ``run(8000)``; the bounds of ``check_cosmos``: gain within 10%
  of 7, 0.15 < proximity < 0.28, lamda < 0.35, 0.08 < pi[0, 1] < 0.28 and
  MCC > 0.9;
* ``--model cosmos+hmm``: N=12, F=80, kon = koff = 0.2, a cold fit of
  ``run(16000)``; gain, proximity and lamda as above, trans[0, 0, 1] (kon)
  and trans[0, 1, 0] (koff) within 0.08 of 0.2, and MCC > 0.9;
* ``--model crosstalk``: N=12, F=40, C=2, pi 0.3, alpha [[0.85, 0.15],
  [0.1, 0.9]], ``run(8000)``; gain within 10% of 7, |alpha[0, 0] - 0.85| <
  0.05, |alpha[1, 1] - 0.90| < 0.05 and MCC > 0.9.

The simulation parameters (common width 1.4, gain 7, lamda 0.15, proximity
0.2, offset 90, height 3000, background 150) are those of the check. MCC is
the port's numpy MCC between the simulator's labels and p(z > 0) > 0.5 from
``z_probs``, as ``recovery_driver._mcc`` computes it.

The cross-check (the "End to end" bar of ROADMAP.md): the port's gain,
proximity and lamda means fall in JAX fit 0's 95% credible intervals, JAX
fit 0's means fall in the port's, and |MCC_port - MCC_jax0| <= 0.02. The
same bar applied to JAX fit 1 against fit 0, from the golden alone, is the
reference's own spread: a component the reference fails is "not decidable
at this budget" and is not gated; every component it passes is.

Usage: ``python3 scripts/recovery_torch.py [--model cosmos|cosmos+hmm|crosstalk]``
(needs a card). Prints one JSON line with the recovered values, each
bound's verdict, the bar, the fit's wall time and the card's name and power
limit; exits 1 if a bound or a gated component of the bar fails.
``main(model, iters, device)`` lets a test rehearse it briefly on the CPU;
``run`` returns the line's object.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from tapqir_tpu_torch.models import models  # noqa: E402
from tapqir_tpu_torch.utils.dataset import load  # noqa: E402
from tapqir_tpu_torch.utils.stats import matthews_corrcoef  # noqa: E402

ITERS = 8000
SEED = 0
BASE = {
    "width": 1.4, "gain": 7.0, "lamda": 0.15, "proximity": 0.2,
    "offset": 90.0, "height": 3000, "background": 150,
}
# model -> (simulation parameters, N, F, steps); the data itself is the golden's
CONFIGS = {
    "cosmos": ({**BASE, "pi": 0.15}, 20, 80, ITERS),
    "cosmos+hmm": ({**BASE, "kon": 0.2, "koff": 0.2}, 12, 80, 2 * ITERS),
    "crosstalk": ({**BASE, "pi": 0.3, "alpha": [[0.85, 0.15], [0.1, 0.9]]}, 12, 40,
                  ITERS),
}
GOLDEN = ROOT / "tests" / "golden"
CI = 0.95
BAR_PARAMS = ("gain", "proximity", "lamda")
SUMMARY_PARAMS = BAR_PARAMS + ("pi", "init", "trans", "alpha")
MCC_MARGIN = 0.02
NOT_DECIDABLE = "not decidable at this budget"


def golden_path(model_name):
    return GOLDEN / f"crosscheck_jax_{model_name}.npz"


def load_golden(model_name):
    """The golden's dataset (images as float32, as the simulator made them),
    its fits' summaries ``{"fit0": ..., "fit1": ...}`` and its metadata."""
    path = golden_path(model_name)
    data = load(path)
    data.images = data.images.astype(np.float32)
    fits, meta = {}, {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            if not key.startswith("fit"):
                continue
            parts = key.split("/")
            fit = fits.setdefault(parts[0], {})
            if len(parts) == 3:
                fit.setdefault(parts[1], {})[parts[2]] = z[key]
            else:
                fit[parts[1]] = z[key].item()
        meta["config"] = json.loads(str(z["config"]))
        meta["jax_version"] = str(z["jax_version"])
    return data, fits, meta


def port_summary(model, mcc):
    """Mean / LL / UL at CI 0.95 of the bar's parameters and of pi, init,
    trans or alpha as the model has them, plus ``mcc``."""
    model.ci_params = [p for p in model.ci_params if p in SUMMARY_PARAMS]
    ci = model.compute_params(CI)
    out = {p: {s: np.asarray(ci[p][s], np.float64) for s in ("Mean", "LL", "UL")}
           for p in model.ci_params}
    out["mcc"] = float(mcc)
    return out


def bar(candidate, reference, params=BAR_PARAMS, margin=MCC_MARGIN):
    """The "End to end" bar of ``candidate`` against ``reference``: for each
    parameter, whether every mean of one lies in the other's 95% interval
    (both ways), and whether the MCCs differ by at most ``margin``."""
    def within(mean, other):
        mean = np.asarray(mean)
        return bool(np.all((other["LL"] <= mean) & (mean <= other["UL"])))

    components = {}
    for p in params:
        components[f"{p} mean in the reference's interval"] = within(
            candidate[p]["Mean"], reference[p])
        components[f"the reference's {p} mean in its interval"] = within(
            reference[p]["Mean"], candidate[p])
    components[f"|dMCC| <= {margin}"] = bool(
        abs(candidate["mcc"] - reference["mcc"]) <= margin)
    return components


def crosscheck(port, jax0, jax1):
    """The bar of the port against JAX fit 0, gated where JAX fit 1 passes
    it against fit 0 and reported as "not decidable at this budget" where
    the reference itself fails."""
    ported, spread = bar(port, jax0), bar(jax1, jax0)
    verdicts = {
        name: (("pass" if ported[name] else "fail") if spread[name] else NOT_DECIDABLE)
        for name in ported
    }
    return {
        "port_vs_jax0": ported,
        "jax1_vs_jax0": spread,
        "verdicts": verdicts,
        "not_decidable": [n for n, v in verdicts.items() if v == NOT_DECIDABLE],
        "ok": all(v != "fail" for v in verdicts.values()),
        "mcc": {"port": port["mcc"], "jax0": jax0["mcc"], "jax1": jax1["mcc"]},
    }


def _reported(summary):
    """A summary's parameters (Mean / LL / UL as lists) and MCC, for the JSON line."""
    return {p: ({s: np.asarray(v).tolist() for s, v in stats.items()}
                if isinstance(stats, dict) else stats)
            for p, stats in summary.items() if p in SUMMARY_PARAMS or p == "mcc"}


def _card(device):
    if torch.device(device).type != "cuda":
        return {"device": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def _values_and_bounds(model_name, model, p, true_z):
    values = {"gain": float(model.param("gain_loc"))}
    bounds = {"gain within 10% of 7": abs(values["gain"] - 7.0) / 7.0 < 0.10}
    if model_name == "crosstalk":
        alpha = model.param("alpha_mean")
        values["alpha_00"], values["alpha_11"] = float(alpha[0, 0]), float(alpha[1, 1])
        bounds["|alpha[0, 0] - 0.85| < 0.05"] = abs(values["alpha_00"] - 0.85) < 0.05
        bounds["|alpha[1, 1] - 0.90| < 0.05"] = abs(values["alpha_11"] - 0.90) < 0.05
    else:
        values["proximity"] = float(model.param("proximity_loc"))
        values["lamda"] = float(model.param("lamda_loc")[0])
        bounds["0.15 < proximity < 0.28"] = 0.15 < values["proximity"] < 0.28
        bounds["lamda < 0.35"] = values["lamda"] < 0.35
    if model_name == "cosmos":
        values["pi_1"] = float(model.param("pi_mean")[0, 1])
        bounds["0.08 < pi[0, 1] < 0.28"] = 0.08 < values["pi_1"] < 0.28
    elif model_name == "cosmos+hmm":
        trans = model.param("trans_mean")[0]  # (1+S, 1+S)
        values["kon"], values["koff"] = float(trans[0, 1]), float(trans[1, 0])
        bounds["|kon - 0.2| < 0.08"] = abs(values["kon"] - 0.2) < 0.08
        bounds["|koff - 0.2| < 0.08"] = abs(values["koff"] - 0.2) < 0.08
    values["mcc"] = matthews_corrcoef(true_z.ravel() > 0, (p > 0.5).ravel())
    bounds["MCC > 0.9"] = values["mcc"] > 0.9
    return values, bounds


def run(model_name="cosmos", iters=None, device="cuda"):
    """Fit the golden's dataset and return the JSON line's object."""
    _, N, F, steps = CONFIGS[model_name]
    iters = steps if iters is None else iters
    data, golden, meta = load_golden(model_name)
    if (data.Nt, data.F) != (N, F):
        raise ValueError(f"{golden_path(model_name).name} holds Nt={data.Nt}, F={data.F}; "
                         f"the check fits N={N}, F={F}")
    model = models[model_name](device=device)
    with tempfile.TemporaryDirectory(prefix="recovery_torch_") as tmp:
        model.data = data
        model.path = Path(tmp)
        model.run_path = Path(tmp) / ".tapqir"
        model.init(lr=0.005, nbatch_size=min(N, 10), fbatch_size=min(F, 512))
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.run(iters)
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        fit_seconds = time.perf_counter() - t0
        t1 = time.perf_counter()
        z_probs = model.z_probs
        probs_seconds = time.perf_counter() - t1

    n_on = data.N
    p = z_probs[:n_on, ..., 1:].sum(-1)  # (n_on, F, Q)
    true_z = np.asarray(data.labels["z"][:n_on]).reshape(p.shape)
    values, bounds = _values_and_bounds(model_name, model, p, true_z)
    port = port_summary(model, values["mcc"])
    check = crosscheck(port, golden["fit0"], golden["fit1"])
    check.update(
        golden=golden_path(model_name).name,
        jax_version=meta["jax_version"],
        jax_steps=[int(golden[f]["steps"]) for f in ("fit0", "fit1")],
        port=_reported(port), jax0=_reported(golden["fit0"]), jax1=_reported(golden["fit1"]),
    )
    return {
        "values": values,
        "bounds": bounds,
        "crosscheck": check,
        "ok": all(bounds.values()) and check["ok"],
        "model": model_name,
        "iters": model.iter,
        "loss": model.iter_loss,
        "fit_seconds": fit_seconds,
        "steps_per_s": iters / fit_seconds,
        "z_probs_seconds": probs_seconds,
        **_card(device),
    }


def main(model_name="cosmos", iters=None, device="cuda"):
    result = run(model_name, iters, device)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        description="Parameter recovery on a CUDA card, held against the JAX fits.")
    ap.add_argument("--model", choices=sorted(CONFIGS), default="cosmos")
    sys.exit(main(ap.parse_args().model))
