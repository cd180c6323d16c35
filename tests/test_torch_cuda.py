"""Tests of the port's CUDA kernel; they need the card and skip without one
(a CUDA kernel has no CPU mode - its plain version is tested on the CPU in
test_torch_likelihood.py). Run them on a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -m cuda

The kernel is held against its plain PyTorch version at the tolerances
stated in chip_smoke.py (forward rtol 3e-5 / atol 1e-2, gradient rtol 2e-4 /
atol 1e-4 in float32; 1e-9 and 1e-6 in float64).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
pytestmark = pytest.mark.cuda


@pytest.fixture
def cs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CASES = {
    "small": dict(M=4, nb=20, EVP=256, ev=196, J=7, dtype=torch.float32),
    "below-every-bin": dict(M=4, nb=16, EVP=256, ev=196, J=61, dtype=torch.float32,
                            below=True),
    "ev-masked": dict(M=4, nb=16, EVP=256, ev=130, J=61, dtype=torch.float32),
    "ragged-nb": dict(M=4, nb=37, EVP=256, ev=196, J=61, dtype=torch.float32),
    "M16": dict(M=16, nb=24, EVP=256, ev=196, J=61, dtype=torch.float32),
    "float64": dict(M=4, nb=12, EVP=256, ev=196, J=7, dtype=torch.float64),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain(cs, case):
    c = dict(CASES[case])
    f64 = c["dtype"] == torch.float64
    errs = cs.compare(
        c["M"], c["nb"], c["EVP"], c["ev"], c["J"], c["dtype"], 3,
        cs.F64_TOL if f64 else cs.FWD_TOL, cs.F64_GRAD_TOL if f64 else cs.GRAD_TOL,
        below=c.get("below", False),
    )
    assert all(np.isfinite(v) for v in errs.values())


def test_launcher_checks_its_inputs(cs):
    from tapqir_tpu_torch.ops import offset_gamma as og

    x, a, rate, g, w = cs.kernel_inputs(2, 4, 256, 196, 7, torch.float32, 0, "cuda")
    r1 = rate.reshape(1)
    with pytest.raises(TypeError):
        og.summed_fwd(x.double(), a, r1, g, w, 196)
    with pytest.raises(ValueError):
        og.summed_fwd(x, a.transpose(1, 2), r1, g, w, 196)
    with pytest.raises(ValueError):
        og.summed_fwd(x, a, r1, g, w, 300)
    big = torch.linspace(0, 50, 2000, device="cuda")
    with pytest.raises(ValueError):
        og.summed_fwd(x, a, r1, big, big, 196)
    n = og.summed_fwd.launches
    og.summed_fwd(x, a, r1, g, w, 196)
    assert og.summed_fwd.launches == n + 1


def test_cosmos_fit_on_the_card(cs, tmp_path):
    res = cs.run_main_path(tmp_path, Nt=16, F=40, P=14, J=11, nbatch=4, fbatch=16,
                           num_iter=20, device="cuda", n_chunk=2)
    cs.check_main_path(res, 20)
    assert res["launches"]["stats"] == 20 and res["launches"]["fwd"] == 1
