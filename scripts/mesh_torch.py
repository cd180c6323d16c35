#!/usr/bin/env python3
"""The port's mesh (``tapqir_tpu_torch/parallel/sharding.py``) on the card
or cards of this machine: ``chip_smoke.py``'s phases 22-24 alone, and, with
more than one card, the command line's ``fit --mesh auto`` and ``stats
--mesh auto``.

Run from the repository root with no arguments: ``python3
scripts/mesh_torch.py``. With four or more cards each rank has a card of
its own and the ranks meet over NCCL (gloo for CPU tensors); with fewer,
the ranks share ``cuda:0`` over gloo, as ``chip_smoke.py``'s phases do. It
simulates and saves the eLife-width cosmos dataset of ``chip_smoke.py``
phase 7 (Nt=856, F=790, 61 offset bins) and a two-color crosstalk dataset
cut to F=512 frames (a 2x1 mesh rank's step takes 10 x 512 x 2 images at
any F of 512 or more; the cut saves a minute of writing), then runs cosmos
on 2x2, cosmos+hmm on 1x2, crosstalk on 2x1 and restarts on 2x2 with
``chip_smoke.py``'s checks, and the command line on an AOI mesh over every
card. Prints each phase's numbers beside the card's name and power limit,
then one JSON line of the results; exits 1 when a check fails and without
a card.
"""

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("mesh_torch: no CUDA device is available", file=sys.stderr)
        return 1
    import tapqir_tpu_torch.models  # noqa: F401  declares every kernel's library
    from tapqir_tpu_torch.csrc import native

    t_start = time.perf_counter()
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    devices = [f"cuda:{i}" for i in range(4)] if count >= 4 else ["cuda:0"] * 4
    print(f"[device] {name} x {count} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | mesh devices {devices}", flush=True)
    native.build_cuda()
    walls = {}

    def lap(phase):
        walls[phase] = round(time.perf_counter() - t_start, 3)
        print(f"[wall] {phase} done at {walls[phase]} s", flush=True)

    with tempfile.TemporaryDirectory(prefix="mesh_torch_") as tmp:
        setup = cs.prepare_dataset(tmp, device="cuda")
        xws = Path(tmp) / "crosstalk"
        xws.mkdir()
        setup_xt = cs.prepare_dataset(xws, F=512, C=2, params=cs.XTALK_PARAMS, device="cuda")
        lap("datasets")
        res = cs.run_mesh_phases(tmp, xws, devices, lap=lap)
        checks = cs.check_mesh_phases(res, Nt=856, F=790)
        cli = cs.run_mesh_cli(tmp) if count > 1 else None
        lap("command line")
    cs.print_mesh_phases(res, checks, cli, name, smi[0])
    print(json.dumps({"device": name, "count": count, "smi": smi, "devices": devices,
                      "setup": [setup, setup_xt], "walls": walls, "checks": checks,
                      "cli": cli, "results": res}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
