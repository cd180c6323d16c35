#!/usr/bin/env python3
"""Parameter recovery of the PyTorch port's fits on a CUDA card: the port's
counterparts of ``check_cosmos`` and ``check_hmm`` in tests/recovery_driver.py.

``--model cosmos`` (the default): simulates with the port N=20 AOIs (10 on
target), F=80 frames, C=1, P=14 (width 1.4, gain 7, lamda 0.15, proximity
0.2, offset 90, height 3000, background 150, pi 0.15), fits cosmos with
``init(lr=0.005, nbatch_size=10, fbatch_size=80)`` and ``run(8000)``, and
checks the bounds of ``check_cosmos``: gain within 10% of 7, 0.15 <
proximity < 0.28, lamda < 0.35, 0.08 < pi[0, 1] < 0.28, and MCC > 0.9.

``--model cosmos+hmm``: the same parameters with kon = koff = 0.2 in place
of pi, N=12 AOIs, F=80 frames, a cold hmm fit of ``run(16000)`` with
``nbatch_size=10``, and the bounds of ``check_hmm``: gain, proximity and
lamda as above, trans[0, 0, 1] (kon) and trans[0, 1, 0] (koff) within 0.08
of 0.2, and MCC > 0.9.

MCC is the port's numpy MCC between the simulator's labels and p(z > 0) >
0.5 from ``z_probs``.

Usage: ``python3 scripts/recovery_torch.py [--model cosmos|cosmos+hmm]``
(needs a card). Prints one JSON line with the recovered values, each
bound's verdict, the fit's wall time and the card's name and power limit;
exits 1 if a bound fails. ``main(model, iters, device)`` lets a test
rehearse it briefly on the CPU.
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

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from tapqir_tpu_torch.models import models  # noqa: E402
from tapqir_tpu_torch.utils.simulate import simulate  # noqa: E402
from tapqir_tpu_torch.utils.stats import matthews_corrcoef  # noqa: E402

ITERS = 8000
SEED = 0
BASE = {
    "width": 1.4, "gain": 7.0, "lamda": 0.15, "proximity": 0.2,
    "offset": 90.0, "height": 3000, "background": 150,
}
# model -> (simulation parameters, N, F, steps)
CONFIGS = {
    "cosmos": ({**BASE, "pi": 0.15}, 20, 80, ITERS),
    "cosmos+hmm": ({**BASE, "kon": 0.2, "koff": 0.2}, 12, 80, 2 * ITERS),
}


def _card(device):
    if torch.device(device).type != "cuda":
        return {"device": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def _values_and_bounds(model_name, model, p, true_z):
    values = {
        "gain": float(model.param("gain_loc")),
        "proximity": float(model.param("proximity_loc")),
        "lamda": float(model.param("lamda_loc")[0]),
    }
    bounds = {
        "gain within 10% of 7": abs(values["gain"] - 7.0) / 7.0 < 0.10,
        "0.15 < proximity < 0.28": 0.15 < values["proximity"] < 0.28,
        "lamda < 0.35": values["lamda"] < 0.35,
    }
    if model_name == "cosmos":
        values["pi_1"] = float(model.param("pi_mean")[0, 1])
        bounds["0.08 < pi[0, 1] < 0.28"] = 0.08 < values["pi_1"] < 0.28
    else:
        trans = model.param("trans_mean")[0]  # (1+S, 1+S)
        values["kon"], values["koff"] = float(trans[0, 1]), float(trans[1, 0])
        bounds["|kon - 0.2| < 0.08"] = abs(values["kon"] - 0.2) < 0.08
        bounds["|koff - 0.2| < 0.08"] = abs(values["koff"] - 0.2) < 0.08
    values["mcc"] = matthews_corrcoef(true_z.ravel() > 0, (p > 0.5).ravel())
    bounds["MCC > 0.9"] = values["mcc"] > 0.9
    return values, bounds


def main(model_name="cosmos", iters=None, device="cuda"):
    params, N, F, steps = CONFIGS[model_name]
    iters = steps if iters is None else iters
    data = simulate(model_name, N=N, F=F, C=1, P=14, seed=SEED, params=params,
                    device=device)
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
    result = {
        "values": values,
        "bounds": bounds,
        "ok": all(bounds.values()),
        "model": model_name,
        "iters": model.iter,
        "fit_seconds": fit_seconds,
        "steps_per_s": iters / fit_seconds,
        "z_probs_seconds": probs_seconds,
        **_card(device),
    }
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="Parameter recovery on a CUDA card.")
    ap.add_argument("--model", choices=sorted(CONFIGS), default="cosmos")
    sys.exit(main(ap.parse_args().model))
