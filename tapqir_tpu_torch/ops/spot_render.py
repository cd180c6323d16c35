"""Cosmos's spot render and config assembly: the concentration that the
likelihood scores, its two CUDA kernels (``csrc/spot_render.cu``), and its
plain PyTorch version.

:func:`spot_concentration` returns, for every spot-presence config m of the
(M, K) table ``mtab``,

    (b + sum_k mtab[m, k] h_k N(p; target + (x_k, y_k), w_k^2)) / gain

on each image's flat pixel axis (p = row * P + column, lanes >= P * P hold
``b / gain``), in the (M, *lead, n * f * C, EVP) layout that
``offset_gamma_log_prob_summed`` takes. ``lead`` is a leading chain axis
(R,) with a gain per chain, or none.

On CUDA tensors the forward is one launch of ``render`` and the backward
one launch of ``render_grad`` (plus one small fixed-order sum of the gain's
per-image partials); their launch counts are on those launchers. CPU
tensors take :func:`spot_concentration_plain`: the render
(``gaussian_spots_flat``), an einsum over the configs and the division, op
by op. There is no fallback from one to the other.
"""

import ctypes
import math

import torch

from tapqir_tpu_torch.csrc import native
from tapqir_tpu_torch.distributions.util import gaussian_spots_flat
from tapqir_tpu_torch.ops.offset_gamma import config_masks


def spot_concentration_plain(b, h, w, xs, ys, target_locs, gain, mtab, P, ev_pad):
    """:func:`spot_concentration` op by op: spots rendered spot-last
    (*lead, n, f, C, K, EVP), the configs by one einsum, then the gain."""
    lead = tuple(b.shape[:-3])
    nfc = math.prod(b.shape[-3:])
    K = h.shape[-1]
    mtab = torch.as_tensor(mtab, dtype=h.dtype, device=h.device)
    gauss = gaussian_spots_flat(
        h, w, xs, ys, target_locs, P, ev_pad
    )  # (*lead, n, f, C, K, EVP)
    gauss_flat = gauss.reshape(lead + (nfc, K, ev_pad))
    img_flat = b.reshape(lead + (nfc, 1)) + torch.einsum(
        "mk,...xkp->m...xp", mtab, gauss_flat
    )  # (M, *lead, nfc, EVP)
    return img_flat / gain.reshape(gain.shape + (1, 1))


# ---------------------------------------------------------------------------
# the library and its launchers
# ---------------------------------------------------------------------------

_ptr, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# inputs (host array of 7), nb, per_chain, K, masks (host), M, P, EVP
_COMMON = [_ptr, _i64, _i64, _i32, _ptr, _i32, _i32, _i32]
library = native.Library(
    "spot_render.cu", "spot_render",
    {"sr_render": _COMMON + [_ptr, _ptr],  # out, stream
     "sr_render_grad": _COMMON + [_ptr, _ptr, _ptr]},  # go, grads (host array of 7), stream
    probes=("sr_max_spots",),
)


class _Launcher(native.Kernel):
    """One of the two kernels: the render, or with ``grad`` its gradients."""

    def __init__(self, name, entry, grad):
        super().__init__(name, library, entry)
        self.grad = grad

    def __call__(self, inputs, masks, P, EVP, out=None, go=None, grads=None):
        """Launch over ``inputs`` (b (nb,), h, w, xs, ys (nb, K), target
        locations (nb, 2), gain (R,)): the forward writes ``out`` (M, nb,
        EVP); the backward reads ``go`` (M, nb, EVP) and writes ``grads``
        (b's (nb,), h's, w's, xs's, ys's (nb, K), the gain's per-image
        partials (nb,), the gain's (R,) or None)."""
        b, h = inputs[0], inputs[1]
        fn = self.function(b)
        nb, K, M, R = b.shape[0], h.shape[-1], len(masks), inputs[6].shape[0]
        max_spots = library.limits["sr_max_spots"]
        if not 1 <= K <= max_spots or M > 1 << max_spots:
            raise ValueError(f"{K} spots and {M} configs: the kernel takes at most "
                             f"{max_spots} spots")
        if R < 1 or nb % R:
            raise ValueError(f"{nb} images do not split into {R} chains")
        if EVP < P * P:
            raise ValueError(f"{EVP} lanes hold fewer than P * P = {P * P} pixels")
        want = [(nb,), (nb, K), (nb, K), (nb, K), (nb, K), (nb, 2), (R,)]
        if self.grad:
            want += [(M, nb, EVP), (nb,), (nb, K), (nb, K), (nb, K), (nb, K), (nb,), (R,)]
            tensors = list(inputs) + [go] + list(grads)
        else:
            want += [(M, nb, EVP)]
            tensors = list(inputs) + [out]
        native.check_tensors(tensors, b, want)
        ptrs = (ctypes.c_void_p * 7)(*[t.data_ptr() for t in inputs])
        bits = (ctypes.c_uint * M)(*masks)
        args = (ptrs, nb, nb // R, K, bits, M, P, EVP)
        if self.grad:
            gp = (ctypes.c_void_p * 7)(*[None if t is None else t.data_ptr() for t in grads])
            self.launch(fn, b, *args, go.data_ptr(), gp)
        else:
            self.launch(fn, b, *args, out.data_ptr())


render = _Launcher("render", "sr_render", grad=False)  # the concentration, in the forward
render_grad = _Launcher("render_grad", "sr_render_grad", grad=True)  # its gradients


class _RenderFunction(torch.autograd.Function):
    """The two kernels as one autograd node; the backward recomputes the
    spots from the saved inputs, so nothing of the pixel axis is kept."""

    @staticmethod
    def forward(ctx, b, h, w, xs, ys, tl, gain, masks, P, EVP):
        out = torch.empty((len(masks), b.shape[0], EVP), dtype=b.dtype, device=b.device)
        render((b, h, w, xs, ys, tl, gain), masks, P, EVP, out=out)
        ctx.save_for_backward(b, h, w, xs, ys, tl, gain)
        ctx.masks, ctx.P, ctx.EVP = masks, P, EVP
        return out

    @staticmethod
    def backward(ctx, go):
        b, h, w, xs, ys, tl, gain = inputs = ctx.saved_tensors
        nb, K, R = b.shape[0], h.shape[1], gain.shape[0]
        buf = torch.empty((nb * (2 + 4 * K) + R,), dtype=b.dtype, device=b.device)
        gb, gh, gw, gx, gy, part, gg = buf.split([nb] + [nb * K] * 4 + [nb, R])
        gh, gw, gx, gy = (g.view(nb, K) for g in (gh, gw, gx, gy))
        gg = gg if ctx.needs_input_grad[6] else None
        render_grad(inputs, ctx.masks, ctx.P, ctx.EVP, go=go.contiguous(),
                    grads=(gb, gh, gw, gx, gy, part, gg))
        return gb, gh, gw, gx, gy, None, gg, None, None, None


def spot_concentration(b, h, w, xs, ys, target_locs, gain, mtab, P, ev_pad):
    """The (M, *lead, n * f * C, EVP) concentration of every config.

    :param b: (*lead, n, f, C) backgrounds.
    :param h, w, xs, ys: (*lead, n, f, C, K) spot heights, widths and
        offsets from the target.
    :param target_locs: (*lead, n, f, C, 2) target (column, row); data, it
        gets no gradient.
    :param gain: () or (R,) with ``lead == (R,)``: each chain's gain.
    :param mtab: (M, K) 0/1 host table (numpy array or nested sequence) of
        configs; on the card K <= 6.
    :param P: the image's side; ``ev_pad`` >= P * P lanes.
    """
    if h.device.type == "cpu":
        return spot_concentration_plain(b, h, w, xs, ys, target_locs, gain, mtab, P, ev_pad)
    lead = tuple(b.shape[:-3])
    K = h.shape[-1]
    nb = b.numel()
    masks = config_masks(mtab, K)
    for name, t, tail in (("h", h, (K,)), ("w", w, (K,)), ("xs", xs, (K,)), ("ys", ys, (K,)),
                          ("target_locs", target_locs, (2,))):
        if tuple(t.shape) != tuple(b.shape) + tail:
            raise ValueError(f"{name} {tuple(t.shape)} for backgrounds {tuple(b.shape)}")
    if gain.dim() > 1 or (gain.dim() == 1 and lead[:1] != tuple(gain.shape)):
        raise ValueError(f"gain {tuple(gain.shape)} for a leading axis {lead}")
    flat = [t.reshape(nb, -1) for t in (h, w, xs, ys, target_locs)]
    out = _RenderFunction.apply(
        b.reshape(nb).contiguous(), *(t.contiguous() for t in flat),
        gain.reshape(-1).contiguous(), masks, int(P), int(ev_pad),
    )
    return out.reshape((len(masks),) + lead + (math.prod(b.shape[-3:]), ev_pad))
