"""The sparse step's window Adam (``tapqir_tpu_torch/ops/sparse_adam.py``)
on the CPU: the plain versions against a NumPy float64 sparse Adam with
per-row step counts, and the kernels' window layout (slot table and
groups) read back the way the kernels read it, at the cosmos, crosstalk
and cosmos+hmm leaf layouts, with frames subsampled and every frame.

The kernels themselves run only on a card (tests/test_torch_cuda.py).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from tapqir_tpu_torch.ops import sparse_adam as sa

ROOT = Path(__file__).resolve().parent.parent
MODELS = ["cosmos", "crosstalk", "cosmos+hmm"]
Nt, F, N, FB = 13, 11, 4, 6
LR = 0.005


@pytest.fixture(scope="module")
def cs():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _index(ndim, kind, ax, ndx, frames):
    """The numpy index of a leaf's window in its full array."""
    idx = [slice(None)] * ndim
    if kind == "a":
        idx[ax] = ndx
    elif kind == "af":
        idx[ax], idx[ax + 1] = ndx[:, None], frames[None, :]
    return tuple(idx)


def numpy_adam(layout, params, opt, grads, ndx, fidx, lr):
    """The sparse Adam step in float64 numpy, element by element in window
    space: counts bumped per row group (globals once, a row once, a (row,
    frame) once), the bias correction 1 - b^t in float32 for the row groups
    (as the JAX package) and in float64 for the globals."""
    b1, b2, eps = sa.ADAM_B1, sa.ADAM_B2, sa.ADAM_EPS
    p = {k: v.double().numpy().copy() for k, v in params.items()}
    mu = {k: v.double().numpy().copy() for k, v in opt["mu"].items()}
    nu = {k: v.double().numpy().copy() for k, v in opt["nu"].items()}
    count = {k: v.numpy().astype(np.int64).copy() for k, v in opt["count"].items()}
    ndx = ndx.numpy()
    frames = np.arange(F) if fidx is None else fidx.numpy()
    t = {"g": count["g"] + 1, "a": count["a"][ndx] + 1,
         "af": count["af"].reshape(Nt, F)[ndx[:, None], frames[None, :]] + 1}
    count["g"] = t["g"]
    count["a"][ndx] = t["a"]
    count["af"].reshape(Nt, F)[ndx[:, None], frames[None, :]] = t["af"]
    for name, g in zip(layout.names, grads):
        kind, ax = layout.groups[name]
        g = np.where(np.isfinite(g.double().numpy()), g.double().numpy(), 0.0)
        idx = _index(p[name].ndim, kind, ax, ndx, frames)
        if kind == "g":
            c1, c2 = 1.0 - b1 ** float(t["g"]), 1.0 - b2 ** float(t["g"])
        else:
            tt = t[kind].astype(np.float32)
            shape = [1] * ax + list(tt.shape) + [1] * (g.ndim - ax - tt.ndim)
            c1, c2 = (np.float32(1) - np.float32(b) ** tt for b in (b1, b2))
            c1, c2 = c1.astype(np.float64).reshape(shape), c2.astype(np.float64).reshape(shape)
        m2 = b1 * mu[name][idx] + (1 - b1) * g
        v2 = b2 * nu[name][idx] + (1 - b2) * g * g
        p[name][idx] = p[name][idx] - lr * (m2 / c1) / (np.sqrt(v2 / c2) + eps)
        mu[name][idx], nu[name][idx] = m2, v2
    return p, mu, nu, count


def _case(cs, model, f, dtype=torch.float64, seed=0):
    return cs.sparse_adam_case(model, Nt, F, N, f, dtype, seed, "cpu")


@pytest.mark.parametrize("f", [FB, None], ids=["fidx", "every-frame"])
@pytest.mark.parametrize("model", MODELS)
def test_plain_adam_matches_numpy(cs, model, f):
    """window_adam_plain in float64 against the numpy step: parameters and
    moments, inside the window and out, and the counts exactly. A NaN and
    an infinite gradient element are zeroed; the counts start between 0
    and 49."""
    layout, params, opt, grads, ndx, fidx = _case(cs, model, f)
    assert not all(torch.isfinite(g).all() for g in grads)
    assert int(opt["count"]["g"]) > 0 and int(opt["count"]["af"].max()) > 0
    before = {k: v.numpy().copy() for k, v in params.items()}
    want_p, want_mu, want_nu, want_count = numpy_adam(layout, params, opt, grads, ndx, fidx,
                                                      LR)
    win = sa.window_gather_plain(params, layout, ndx, fidx)
    sa.window_adam_plain(params, opt, win, grads, layout, ndx, fidx, LR)
    for k in layout.names:
        # the updates: two libraries' float32 pow may differ by an ulp
        # (6e-8) in b^t, which 1 - b^t turns into up to 6e-8 / (1 - 0.999)
        # = 6e-5 of the row groups' c2, and so 3e-5 of the update
        np.testing.assert_allclose(params[k].numpy() - before[k], want_p[k] - before[k],
                                   rtol=1e-4, atol=1e-15, err_msg=k)
        np.testing.assert_allclose(opt["mu"][k].numpy(), want_mu[k], rtol=1e-13, atol=0,
                                   err_msg=k)
        np.testing.assert_allclose(opt["nu"][k].numpy(), want_nu[k], rtol=1e-13, atol=0,
                                   err_msg=k)
    for k, v in opt["count"].items():
        np.testing.assert_array_equal(v.numpy(), want_count[k], err_msg=k)


@pytest.mark.parametrize("f", [FB, None], ids=["fidx", "every-frame"])
@pytest.mark.parametrize("model", MODELS)
def test_plain_adam_float32_follows_numpy(cs, model, f):
    """The same step in float32 against the numpy float64 step, within
    float32 rounding of each operation: the update moves every window
    element and none outside."""
    layout, params, opt, grads, ndx, fidx = _case(cs, model, f, torch.float32, seed=1)
    before = {k: v.clone() for k, v in params.items()}
    want_p, want_mu, want_nu, _ = numpy_adam(layout, params, opt, grads, ndx, fidx, LR)
    win = sa.window_gather_plain(params, layout, ndx, fidx)
    sa.window_adam_plain(params, opt, win, grads, layout, ndx, fidx, LR)
    moved = 0
    for k in layout.names:
        np.testing.assert_allclose(params[k].numpy(), want_p[k], rtol=2e-6, atol=1e-7,
                                   err_msg=k)
        # mu2 = b1 mu + (1 - b1) g may cancel: rounding of terms up to ~0.8
        np.testing.assert_allclose(opt["mu"][k].numpy(), want_mu[k], rtol=2e-6, atol=1e-7,
                                   err_msg=k)
        np.testing.assert_allclose(opt["nu"][k].numpy(), want_nu[k], rtol=2e-6, atol=1e-12,
                                   err_msg=k)
        moved += int((params[k] != before[k]).sum())
    assert moved == layout.total


def _kernel_reads(layout, ndx, fidx):
    """Per slot of the layout, as the kernels compute them: the group, the
    leaf, the block of every position, the count index, and the full and
    window offsets (``meta`` and ``slots`` read back)."""
    meta, ndx = layout.meta, ndx.numpy()
    f, F_ = meta[15], meta[16]
    out = []
    for gi in range(3):
        npos, P, blocks, s0, s1 = meta[5 * gi:5 * gi + 5]
        if not blocks:
            assert s0 == s1
            continue
        assert 1 <= P <= sa.THREADS and blocks == -(-npos // P)
        assert P * (s1 - s0) <= max(sa.BLOCK_ELEMENTS, s1 - s0)
        pos = np.arange(npos)
        if gi == 0:
            cidx = np.zeros(1, np.int64)
        elif gi == 1:
            cidx = ndx[pos]
        else:
            j = pos % f
            cidx = ndx[pos // f] * F_ + (j if fidx is None else fidx.numpy()[j])
        for leaf, stride, full_base, win_base in layout.slots[s0:s1]:
            out.append((gi, leaf, pos // P, cidx, full_base + cidx * stride,
                        win_base + pos * stride))
    return out


@pytest.mark.parametrize("f", [FB, None], ids=["fidx", "every-frame"])
@pytest.mark.parametrize("model", MODELS)
def test_layout_reads_what_the_plain_gather_reads(cs, model, f):
    """The slot table read as the kernels read it: every window element of
    every leaf written once, each from the full element the plain gather
    takes; each step count in one block of one group only, so its readers
    and its bump share a block; the windows' shapes and flat offsets."""
    layout, params, opt, grads, ndx, fidx = _case(cs, model, f)
    plain = sa.window_gather_plain(params, layout, ndx, fidx)
    flat = [params[k].numpy().reshape(-1) for k in layout.names]
    got = [np.full(s, np.nan) for s in layout.sizes]
    hits = [np.zeros(s, np.int64) for s in layout.sizes]
    owner = {}
    for gi, leaf, block, cidx, full, win in _kernel_reads(layout, ndx, fidx):
        got[leaf][win] = flat[leaf][full]
        np.add.at(hits[leaf], win, 1)
        for c, b in zip(np.broadcast_to(cidx, block.shape), block):
            assert owner.setdefault((gi, int(c)), int(b)) == int(b)
    for leaf, k in enumerate(layout.names):
        assert plain[k].shape == layout.shapes[leaf]
        assert (hits[leaf] == 1).all(), k
        np.testing.assert_array_equal(got[leaf], plain[k].detach().numpy().reshape(-1),
                                      err_msg=k)
    assert layout.total == sum(layout.sizes) and layout.slots_dev is None


def test_cpu_tensors_take_the_plain_path_and_the_launcher_refuses_them(cs):
    """On the CPU the entry points are the plain versions (no launch is
    counted); the launcher raises on CPU tensors before it builds."""
    layout, params, opt, grads, ndx, fidx = _case(cs, "cosmos", FB)
    gathers, adams = sa.gather.launches, sa.adam.launches
    win = sa.window_gather(params, layout, ndx, fidx)
    want = sa.window_gather_plain(params, layout, ndx, fidx)
    assert all(torch.equal(win[k], want[k]) and win[k].requires_grad for k in want)
    p, o = cs._clone_case(params, opt)
    sa.window_adam(params, opt, win, grads, layout, ndx, fidx, LR)
    sa.window_adam_plain(p, o, want, grads, layout, ndx, fidx, LR)
    assert all(torch.equal(params[k], p[k]) for k in p)
    assert (sa.gather.launches, sa.adam.launches) == (gathers, adams)
    with pytest.raises(ValueError, match="CUDA"):
        sa.adam(layout, [params[k] for k in layout.names], None, None, grads, ndx, fidx)
