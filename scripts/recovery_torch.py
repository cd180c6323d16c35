#!/usr/bin/env python3
"""Parameter recovery of the PyTorch port's cosmos fit on a CUDA card: the
port's counterpart of ``check_cosmos`` in tests/recovery_driver.py.

Simulates with the port (N=20 AOIs of which 10 on target, F=80 frames, C=1,
P=14; width 1.4, gain 7, lamda 0.15, proximity 0.2, offset 90, height 3000,
background 150, pi 0.15), fits cosmos with ``init(lr=0.005, nbatch_size=10,
fbatch_size=80)`` and ``run(8000)``, and checks the bounds of ``check_cosmos``:
gain within 10% of 7, 0.15 < proximity < 0.28, lamda < 0.35, 0.08 <
pi[0, 1] < 0.28, and MCC > 0.9 between the simulator's labels and p(z > 0)
> 0.5 from ``z_probs`` (the port's numpy MCC).

Usage: ``python3 scripts/recovery_torch.py`` (no options; needs a card).
Prints one JSON line with the recovered values, each bound's verdict, the
fit's wall time and the card's name and power limit; exits 1 if a bound
fails. ``main(iters, device)`` lets a test rehearse it briefly on the CPU.
"""

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
PARAMS = {
    "width": 1.4, "gain": 7.0, "lamda": 0.15, "proximity": 0.2,
    "offset": 90.0, "height": 3000, "background": 150, "pi": 0.15,
}


def _card(device):
    if torch.device(device).type != "cuda":
        return {"device": "cpu"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}


def main(iters=ITERS, device="cuda"):
    N, F = 20, 80
    data = simulate("cosmos", N=N, F=F, C=1, P=14, seed=SEED, params=PARAMS,
                    device=device)
    model = models["cosmos"](device=device)
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
    values = {
        "gain": float(model.param("gain_loc")),
        "proximity": float(model.param("proximity_loc")),
        "lamda": float(model.param("lamda_loc")[0]),
        "pi_1": float(model.param("pi_mean")[0, 1]),
        "mcc": matthews_corrcoef(true_z.ravel() > 0, (p > 0.5).ravel()),
    }
    bounds = {
        "gain within 10% of 7": abs(values["gain"] - 7.0) / 7.0 < 0.10,
        "0.15 < proximity < 0.28": 0.15 < values["proximity"] < 0.28,
        "lamda < 0.35": values["lamda"] < 0.35,
        "0.08 < pi[0, 1] < 0.28": 0.08 < values["pi_1"] < 0.28,
        "MCC > 0.9": values["mcc"] > 0.9,
    }
    result = {
        "values": values,
        "bounds": bounds,
        "ok": all(bounds.values()),
        "iters": model.iter,
        "fit_seconds": fit_seconds,
        "steps_per_s": iters / fit_seconds,
        "z_probs_seconds": probs_seconds,
        **_card(device),
    }
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
