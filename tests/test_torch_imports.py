"""The PyTorch port stands alone: it imports neither JAX nor the JAX package
(nor click, PyYAML, pandas, scikit-learn, tqdm, matplotlib, ipywidgets or
IPython at module level, which the card's machine may lack), its entry points default to the CUDA card and never fall back to the CPU
unasked, and its kernel wrapper takes the plain path only for CPU tensors."""

import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import tapqir_tpu_torch
from tapqir_tpu_torch.device import resolve_device
from tapqir_tpu_torch.ops import offset_gamma as og

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(tapqir_tpu_torch.__path__, "tapqir_tpu_torch.")
    )


def test_port_imports_without_jax_or_the_jax_package():
    mods = _port_modules()
    assert "tapqir_tpu_torch.models.cosmos" in mods
    assert "tapqir_tpu_torch.ops.offset_gamma" in mods
    assert "tapqir_tpu_torch.ops.scan" in mods and "tapqir_tpu_torch.models.hmm" in mods
    assert "tapqir_tpu_torch.main" in mods and "tapqir_tpu_torch.utils.stats" in mods
    assert {"tapqir_tpu_torch.models.crosstalk", "tapqir_tpu_torch.utils.imscroll",
            "tapqir_tpu_torch.utils.mle_analysis",
            "tapqir_tpu_torch.parallel.restarts", "tapqir_tpu_torch.parallel.sharding",
            "tapqir_tpu_torch.imscroll",
            "tapqir_tpu_torch.imscroll.glimpse_reader",
            "tapqir_tpu_torch.csrc.glimpse_native", "tapqir_tpu_torch.gui"} <= set(mods)
    code = textwrap.dedent(
        f"""
        import importlib, sys
        for blocked in ("jax", "tapqir_tpu", "click", "yaml", "pandas", "sklearn",
                        "tqdm", "matplotlib", "ipywidgets", "IPython"):
            sys.modules[blocked] = None  # importing it raises ImportError
        for name in {mods!r}:
            importlib.import_module(name)
        loaded = [
            k for k, v in sys.modules.items()
            if v is not None and (k == "tapqir_tpu" or k.startswith("tapqir_tpu."))
        ]
        assert not loaded, loaded
        assert not any(k == "jax" or k.startswith("jax.") for k, v in sys.modules.items()
                       if v is not None)
        print("ok", len({mods!r}))
        """
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_mesh_rank_workers_import_no_jax():
    """The mesh tests' rank functions (tests/_torch_mesh_worker.py) and
    chip_smoke.py's, imported in every spawned rank, load neither JAX nor
    the JAX package."""
    code = textwrap.dedent(
        """
        import sys
        sys.path[:0] = ["tests", "."]
        for blocked in ("jax", "tapqir_tpu"):
            sys.modules[blocked] = None  # importing it raises ImportError
        import _torch_mesh_worker, chip_smoke
        assert callable(_torch_mesh_worker.run_cases)
        assert callable(chip_smoke.mesh_cosmos_ranks)
        assert not any(k == "jax" or k.startswith(("jax.", "tapqir_tpu."))
                       for k, v in sys.modules.items() if v is not None)
        print("ok")
        """
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


def test_entry_points_default_to_cuda_and_never_fall_back():
    from tapqir_tpu_torch.models import models
    from tapqir_tpu_torch.utils.simulate import simulate

    assert resolve_device("cpu").type == "cpu"
    for name in ("cosmos", "crosstalk", "cosmos+hmm"):
        assert models[name](device="cpu").device.type == "cpu"
        if torch.cuda.is_available():
            assert models[name]().device == torch.device("cuda:0")
            continue
        with pytest.raises(RuntimeError, match="no CUDA device"):
            models[name]()
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate("cosmos", N=2, F=2, params={"pi": 0.1})


def test_wrapper_takes_plain_path_only_on_cpu():
    rng = np.random.default_rng(0)
    M, nb, EVP, ev, J = 2, 3, 128, 100, 4
    x = torch.tensor(rng.integers(95, 300, (nb, EVP)), dtype=torch.float32)
    a = torch.tensor(rng.uniform(10, 50, (M, nb, EVP)), dtype=torch.float32)
    g = torch.tensor([86.0, 88.0, 90.0, 92.0])
    w = torch.log(torch.full((J,), 0.25))
    rate = torch.tensor(1 / 7.0)
    before = (og.summed_fwd.launches, og.summed_stats.launches)
    got = og.offset_gamma_summed(x, a, rate, g, w, ev)
    want = og.offset_gamma_summed_plain(x, a, rate, g, w, ev)
    assert torch.equal(got, want)
    assert (og.summed_fwd.launches, og.summed_stats.launches) == before
    # the launcher itself refuses CPU tensors instead of falling back
    with pytest.raises(ValueError, match="CUDA tensors"):
        og.summed_stats(x, a, rate.reshape(1), g, w, ev)


def _pixel_and_factored_calls():
    rng = np.random.default_rng(1)
    nb, EVP, ev = 3, 128, 100
    x = torch.tensor(rng.integers(95, 300, (nb, EVP)), dtype=torch.float32)
    a = torch.tensor(rng.uniform(10, 50, (2, nb, EVP)), dtype=torch.float32)
    base = torch.tensor(rng.uniform(10, 50, nb), dtype=torch.float32)
    deltas = torch.tensor(rng.uniform(0, 50, (2, nb, EVP)), dtype=torch.float32)
    mtab = [[0, 0], [1, 0], [0, 1], [1, 1]]
    g = torch.tensor([86.0, 88.0, 90.0, 92.0])
    w = torch.log(torch.full((4,), 0.25))
    rate = torch.tensor(1 / 7.0)
    return {
        "pixel": (
            lambda: og.offset_gamma_log_prob(x, a, rate, g, w),
            lambda: og.offset_gamma_log_prob_plain(x, a, rate, g, w),
            lambda: og.pixel_stats(x.reshape(-1), a.reshape(2, -1), rate.reshape(1), g, w),
        ),
        "factored": (
            lambda: og.offset_gamma_factored_summed(x, base, deltas, mtab, rate, g, w, ev),
            lambda: og.offset_gamma_factored_summed_plain(x, base, deltas, mtab, rate, g, w, ev),
            lambda: og.factored_stats(x, base, deltas, (0, 1, 2, 3), rate.reshape(1), g, w, ev),
        ),
    }


@pytest.mark.parametrize("form", ["pixel", "factored"])
def test_pixel_and_factored_wrappers_take_plain_path_only_on_cpu(form):
    wrapper, plain, launcher = _pixel_and_factored_calls()[form]
    before = {k: v.launches for k, v in og.LAUNCHERS.items()}
    assert torch.equal(wrapper(), plain())
    assert {k: v.launches for k, v in og.LAUNCHERS.items()} == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        launcher()
