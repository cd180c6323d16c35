"""Offset-marginalized Gamma log-likelihood: the CUDA kernels
(``csrc/offset_gamma.cu``), their autograd wrappers, and their plain
PyTorch versions.

Counterpart of tapqir_tpu/ops/offset_gamma.py. For config m and pixel i:

    lp[m, i] = logsumexp_j[w_j + (a-1) log(x-g_j) - b (x-g_j)]
               + a log b - lgamma(a)                 (masked to x > g_j)

in three forms, each with its kernel variants and launch counts:

* per pixel (``offset_gamma_log_prob``; ``pixel_fwd`` / ``pixel_stats``
  replace ``_fwd_kernel`` / ``_fwd_stats_kernel``);
* event-summed over each image's first ``ev`` lanes
  (``offset_gamma_summed``; ``summed_fwd`` / ``summed_stats`` replace
  ``_sum_fwd_kernel`` / ``_sum_stats_kernel``);
* event-summed with the concentration a_m = base + sum_k mtab[m, k] delta_k
  built inside the kernel (``offset_gamma_factored_summed``;
  ``factored_stats`` replaces ``_fact_stats_kernel``).

With a gradient the forward also emits the per-pixel statistics
spl = d/da and spd = d/db, so the backward is elementwise in torch, as the
TPU's backward was XLA. The factored form has no forward-only variant:
without a gradient it drops the statistics, as the JAX package does.

The two event-summed forms take the rate as a scalar or as R per-chain
rates: the images are then R equal runs laid out one after the other
(chain-major), run r scored with rate[r], all in one launch - the fold that
``vmap`` over R restart chains makes of the Pallas grid. The rate gradient
is then per chain.

The kernels are built at first use and loaded through a plain C interface
by ``csrc/native.py``, which also counts their launches. CUDA tensors
always go through a kernel (or raise); CPU tensors take the plain version.
There is no fallback from one to the other.
"""

import ctypes
import math

import numpy as np
import torch

from tapqir_tpu_torch.csrc import native

MAX_FACTORS = 6  # kMaxFactors of the factored kernel
MAX_CONFIGS = 64  # kMaxConfigs


# ---------------------------------------------------------------------------
# plain versions (CPU path and the kernels' reference on the card)
# ---------------------------------------------------------------------------


def offset_gamma_log_prob_plain(value, concentration, rate, offset_samples,
                                offset_logits):
    """Per-pixel log sum_j exp(w_j) Gamma(value - g_j; a, b), exact lgamma;
    the port of ``_offset_gamma_log_prob_xla``. The rate broadcasts against
    the concentration. A pixel below every bin gives -inf."""
    dtype = concentration.dtype
    v = value.to(dtype)[..., None]
    a = concentration[..., None]
    d = v - offset_samples.to(dtype)
    ok = d > 0
    d_safe = torch.where(ok, d, torch.ones_like(d))
    rate_b = rate[..., None] if rate.dim() else rate  # against the bin axis too
    inner = (a - 1.0) * torch.log(d_safe) - rate_b * d_safe + offset_logits.to(dtype)
    inner = torch.where(ok, inner, torch.full_like(inner, -torch.inf))
    lse = torch.logsumexp(inner, dim=-1)
    return concentration * torch.log(rate) - torch.lgamma(concentration) + lse


def image_rates(rate, nb):
    """The rate of each of ``nb`` images as a (nb, 1) column, from a scalar
    or from (R,) per-chain rates over R equal runs of images; a scalar (or
    one rate) stays a 0-dim tensor."""
    if rate.numel() == 1:
        return rate.reshape(())
    if rate.dim() != 1 or nb % rate.shape[0]:
        raise ValueError(
            f"per-chain rates must be (R,) with R dividing the {nb} images, "
            f"got shape {tuple(rate.shape)}"
        )
    return rate.repeat_interleave(nb // rate.shape[0])[:, None]


def offset_gamma_summed_plain(value, concentration, rate, offset_samples,
                              offset_logits, ev):
    """(M, nb) sums over the first ``ev`` lanes of each (nb, EVP) image;
    ``rate`` a scalar or (R,) per-chain rates (see :func:`image_rates`);
    gradients by autograd."""
    EVP = concentration.shape[-1]
    mask = (torch.arange(EVP, device=concentration.device) < ev).to(
        concentration.dtype
    )
    r = image_rates(rate, concentration.shape[-2])
    lp = offset_gamma_log_prob_plain(
        value, concentration, r, offset_samples, offset_logits,
    )
    return (lp * mask).sum(-1)


def offset_gamma_factored_summed_plain(value, base, deltas, mtab, rate,
                                       offset_samples, offset_logits, ev):
    """The factored form through a dense concentration, the JAX package's
    XLA path: a = base + tensordot(mtab, deltas), then the summed plain
    version. Shapes as :func:`offset_gamma_factored_summed`."""
    mt = torch.as_tensor(np.asarray(mtab), dtype=deltas.dtype, device=deltas.device)
    conc = base[..., None] + torch.tensordot(mt, deltas, dims=([1], [0]))
    return offset_gamma_summed_plain(
        value, conc, rate, offset_samples, offset_logits, ev
    )


# ---------------------------------------------------------------------------
# the library and its launchers
# ---------------------------------------------------------------------------

_ptr, _i32 = ctypes.c_void_p, ctypes.c_int
library = native.Library(
    "offset_gamma.cu", "offset_gamma",
    {
        # x, a, g, w, rate, out, spl, spd, M, nb, EVP, ev, J, nbr, stats,
        # stream
        "og_summed": [_ptr] * 8 + [_i32] * 7 + [_ptr],
        # x, base, deltas, mask bits (host), g, w, rate, out, spl, spd,
        # M, Kf, nb, EVP, ev, J, nbr, stream
        "og_factored": [_ptr] * 10 + [_i32] * 7 + [_ptr],
        # x, a, g, w, rate, out, spl, spd, M, n_px, J, stats, stream
        "og_pixel": [_ptr] * 8 + [_i32, ctypes.c_longlong, _i32, _i32, _ptr],
    },
    probes=("og_max_bins", "og_max_runs"),
)


def _check_ev(ev, EVP):
    if not 0 < ev <= EVP:
        raise ValueError(f"ev={ev} outside (0, {EVP}]")


class _Launcher(native.Kernel):
    """One kernel variant; ``stats`` says whether it emits the per-pixel
    statistics."""

    def __init__(self, name, entry, stats):
        super().__init__(name, library, entry)
        self.stats = stats

    def _inputs(self, x, a, rate, g, w, nb=None):
        """What every launch takes: ``a`` sets the device and dtype of
        contiguous inputs, (J,) offsets within the kernel's limit and one
        rate, or, for a summed kernel over ``nb`` images, R per-chain rates
        (R,) with R dividing nb. Returns the entry for the dtype."""
        fn = self.function(a)
        if g.ndim != 1 or w.shape != g.shape:
            raise ValueError("offsets must be (J,) vectors")
        if nb is None and rate.numel() != 1:
            raise ValueError("rate must be a scalar")
        if nb is not None and (rate.ndim != 1 or nb % max(rate.shape[0], 1)):
            raise ValueError(f"rate must be (R,) with R dividing the {nb} images, got shape "
                             f"{tuple(rate.shape)}")
        native.check_tensors((x, a, rate, g, w), a)
        max_bins, max_runs = library.limits["og_max_bins"], library.limits["og_max_runs"]
        if g.shape[0] > max_bins:
            raise ValueError(f"{g.shape[0]} offset bins exceed the kernel's {max_bins}")
        if nb is not None and not 1 <= rate.shape[0] <= max_runs:
            raise ValueError(f"{rate.shape[0]} rates: the kernel takes 1..{max_runs}")
        return fn

    def _outputs(self, out_shape, stats_shape, like):
        out = torch.empty(out_shape, dtype=like.dtype, device=like.device)
        if not self.stats:
            return out, None, None
        return (out, torch.empty(stats_shape, dtype=like.dtype, device=like.device),
                torch.empty(stats_shape, dtype=like.dtype, device=like.device))

    @staticmethod
    def _ptr(t):
        return None if t is None else t.data_ptr()


class _SummedLauncher(_Launcher):
    def __call__(self, x2, a3, rate, g, w, ev):
        """x2 (nb, EVP), a3 (M, nb, EVP), rate (R,) over R runs of nb / R
        images, g and w (J,). Returns out (M, nb) and, for the statistics
        variant, spl and spd (M, nb, EVP)."""
        if a3.ndim != 3 or x2.ndim != 2 or x2.shape != a3.shape[1:]:
            raise ValueError(f"shapes: value {tuple(x2.shape)} vs concentration {tuple(a3.shape)}")
        M, nb, EVP = a3.shape
        fn = self._inputs(x2, a3, rate, g, w, nb)
        _check_ev(ev, EVP)
        out, spl, spd = self._outputs((M, nb), a3.shape, a3)
        self.launch(
            fn, a3, x2.data_ptr(), a3.data_ptr(), g.data_ptr(), w.data_ptr(),
            rate.data_ptr(), out.data_ptr(), self._ptr(spl), self._ptr(spd),
            M, nb, EVP, int(ev), g.shape[0], nb // rate.shape[0], int(self.stats),
        )
        return (out, spl, spd) if self.stats else out


class _PixelLauncher(_Launcher):
    def __call__(self, x, a2, rate, g, w):
        """x (n_px,), a2 (M, n_px), rate (1,), g and w (J,). Returns out (M,
        n_px) and, for the statistics variant, spl and spd (M, n_px)."""
        fn = self._inputs(x, a2, rate, g, w)
        if a2.ndim != 2 or x.ndim != 1 or x.shape[0] != a2.shape[1]:
            raise ValueError(f"shapes: value {tuple(x.shape)} vs concentration {tuple(a2.shape)}")
        M, n_px = a2.shape
        out, spl, spd = self._outputs(a2.shape, a2.shape, a2)
        self.launch(
            fn, a2, x.data_ptr(), a2.data_ptr(), g.data_ptr(), w.data_ptr(),
            rate.data_ptr(), out.data_ptr(), self._ptr(spl), self._ptr(spd),
            M, n_px, g.shape[0], int(self.stats),
        )
        return (out, spl, spd) if self.stats else out


class _FactoredLauncher(_Launcher):
    def __call__(self, x2, base, deltas, masks, rate, g, w, ev):
        """x2 (nb, EVP), base (nb,), deltas (Kf, nb, EVP), masks: M ints
        (bit k of masks[m] says config m holds spot k), rate (R,) over R
        runs of nb / R images, g and w (J,). Returns out (M, nb), spl and
        spd (M, nb, EVP)."""
        Kf, nb, EVP = deltas.shape
        fn = self._inputs(x2, deltas, rate, g, w, nb)
        native.check_tensors((base,), deltas)
        if x2.shape != (nb, EVP) or base.shape != (nb,):
            raise ValueError(
                f"shapes: value {tuple(x2.shape)}, base {tuple(base.shape)} vs "
                f"deltas {tuple(deltas.shape)}"
            )
        M = len(masks)
        if not 1 <= Kf <= MAX_FACTORS or not 1 <= M <= MAX_CONFIGS:
            raise ValueError(
                f"the kernel takes 1..{MAX_FACTORS} factors and 1..{MAX_CONFIGS} "
                f"configs, got Kf={Kf}, M={M}"
            )
        if any(not 0 <= m < (1 << Kf) for m in masks):
            raise ValueError(f"config masks {masks} name spots beyond Kf={Kf}")
        _check_ev(ev, EVP)
        out, spl, spd = self._outputs((M, nb), (M, nb, EVP), deltas)
        bits = (ctypes.c_int * M)(*masks)
        self.launch(
            fn, deltas, x2.data_ptr(), base.data_ptr(), deltas.data_ptr(),
            ctypes.cast(bits, ctypes.c_void_p), g.data_ptr(), w.data_ptr(),
            rate.data_ptr(), out.data_ptr(), spl.data_ptr(), spd.data_ptr(),
            M, Kf, nb, EVP, int(ev), g.shape[0], nb // rate.shape[0],
        )
        return out, spl, spd


# each replaces the Pallas kernel named beside it
summed_fwd = _SummedLauncher("summed_fwd", "og_summed", False)  # _sum_fwd_kernel
summed_stats = _SummedLauncher("summed_stats", "og_summed", True)  # _sum_stats_kernel
pixel_fwd = _PixelLauncher("pixel_fwd", "og_pixel", False)  # _fwd_kernel
pixel_stats = _PixelLauncher("pixel_stats", "og_pixel", True)  # _fwd_stats_kernel
factored_stats = _FactoredLauncher("factored_stats", "og_factored", True)  # _fact_stats_kernel


# ---------------------------------------------------------------------------
# autograd wrappers and entry points
# ---------------------------------------------------------------------------


def _wants_grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _rate_grad(go, spd, R):
    """d/d rate of each of R chains: go * spd summed over its run of
    images (images are chain-major), one sum per chain over the same shape
    as a single-chain launch's, so each chain's gradient is bitwise the
    one R single-chain launches give."""
    nbr = go.shape[1] // R
    runs = [slice(r * nbr, (r + 1) * nbr) for r in range(R)]
    return torch.stack([(go[:, sl, None] * spd[:, sl]).sum() for sl in runs])


class _SummedFunction(torch.autograd.Function):
    """Forward + statistics in one launch; elementwise backward."""

    @staticmethod
    def forward(ctx, x2, a3, rate, g, w, ev):
        out, spl, spd = summed_stats(x2, a3, rate, g, w, ev)
        ctx.save_for_backward(spl, spd)
        ctx.R = rate.shape[0]
        return out

    @staticmethod
    def backward(ctx, go):
        spl, spd = ctx.saved_tensors
        da = go[..., None] * spl
        return None, da, _rate_grad(go, spd, ctx.R), None, None, None


def offset_gamma_summed(value, concentration, rate, offset_samples,
                        offset_logits, ev):
    """Offset-marginalized Gamma log-pdf, event-summed.

    :param value: (nb, EVP) flat images; lanes >= ev are ignored.
    :param concentration: (M, nb, EVP).
    :param rate: scalar tensor (the Gamma rate 1/gain), or (R,) per-chain
        rates over R equal runs of the nb images, run r scored with rate[r].
    :param ev: number of real pixels per image.
    :return: (M, nb) log-probabilities summed over each image's pixels.
    """
    if concentration.device.type == "cpu":
        return offset_gamma_summed_plain(
            value, concentration, rate, offset_samples, offset_logits, ev
        )
    dtype = concentration.dtype
    x2 = value.to(dtype).contiguous()
    a3 = concentration.contiguous()
    g = offset_samples.to(dtype).contiguous()
    w = offset_logits.to(dtype).contiguous()
    rates = rate.to(dtype).reshape(-1)
    if _wants_grad(a3, rates):
        return _SummedFunction.apply(x2, a3, rates, g, w, int(ev))
    return summed_fwd(x2, a3, rates, g, w, int(ev))


class _PixelFunction(torch.autograd.Function):
    """Per-pixel forward + statistics in one launch; elementwise backward
    (``_lse_bwd``)."""

    @staticmethod
    def forward(ctx, x, a2, rate, g, w):
        out, spl, spd = pixel_stats(x, a2, rate, g, w)
        ctx.save_for_backward(spl, spd)
        return out

    @staticmethod
    def backward(ctx, go):
        spl, spd = ctx.saved_tensors
        return None, go * spl, (go * spd).sum().reshape(1), None, None


def pixel_layout(value, concentration):
    """The per-pixel kernel's flat layout of a broadcast call: value as
    (n_px,), concentration as (M, n_px), and the output shape. Leading axes
    that the concentration has and the value lacks become the M configs
    sharing each pixel's value (the JAX kernel's (M,) + value.shape layout,
    M = 1 when the shapes are equal); every other axis broadcasts."""
    shape = torch.broadcast_shapes(value.shape, concentration.shape)
    lead = len(shape) - value.dim()
    px_shape = shape[lead:]
    n_px = math.prod(px_shape)
    x = value.expand(px_shape).reshape(n_px)
    a2 = concentration.expand(shape).reshape(math.prod(shape[:lead]), n_px)
    return x, a2, shape


def offset_gamma_log_prob(value, concentration, rate, offset_samples,
                          offset_logits):
    """Per-pixel log p(value) = log sum_j exp(logits_j) Gamma(value - g_j;
    a, b), the counterpart of ``offset_gamma_log_prob_pallas`` for every
    layout that broadcasts (see :func:`pixel_layout`).

    On the card the rate must be a scalar (0-dim) tensor, since the kernel
    takes one, and any other rate raises; the JAX package sends such a call
    to its XLA path. CPU tensors take the plain version, which broadcasts
    any rate. A pixel below every offset bin gives about -1e30 on the card
    and -inf on the CPU, as the Pallas kernel and the XLA path do.

    :return: log-probabilities of the broadcast shape of value and
        concentration, in the concentration's dtype.
    """
    dtype = concentration.dtype
    rate = torch.as_tensor(rate, dtype=dtype, device=concentration.device)
    if concentration.device.type == "cpu":
        return offset_gamma_log_prob_plain(
            value, concentration, rate, offset_samples, offset_logits
        )
    if rate.dim() != 0:
        raise ValueError(f"the per-pixel kernel takes a scalar rate, got shape {tuple(rate.shape)}")
    x, a2, shape = pixel_layout(value.to(dtype), concentration)
    x, a2 = x.contiguous(), a2.contiguous()
    g = offset_samples.to(dtype).contiguous()
    w = offset_logits.to(dtype).contiguous()
    rate1 = rate.reshape(1)
    if _wants_grad(a2, rate1):
        out = _PixelFunction.apply(x, a2, rate1, g, w)
    else:
        out = pixel_fwd(x, a2, rate1, g, w)
    return out.reshape(shape)


def config_masks(mtab, Kf):
    """An (M, Kf) 0/1 host table as M bitmasks (bit k: spot k present)."""
    mt = np.asarray(mtab)
    if mt.ndim != 2 or mt.shape[1] != Kf:
        raise ValueError(f"mtab {mt.shape} vs deltas Kf={Kf}")
    if not np.isin(mt, (0, 1)).all():
        raise ValueError("mtab entries must be 0 or 1")
    return tuple(int(sum(int(b) << k for k, b in enumerate(row))) for row in mt)


class _FactoredFunction(torch.autograd.Function):
    """Factored forward + statistics in one launch; the backward is
    ``_lse_fact_bwd``'s arithmetic on a base of shape (nb,)."""

    @staticmethod
    def forward(ctx, x2, base, deltas, rate, g, w, masks, ev):
        out, spl, spd = factored_stats(x2, base, deltas, masks, rate, g, w, ev)
        ctx.save_for_backward(spl, spd)
        ctx.masks, ctx.Kf, ctx.R = masks, deltas.shape[0], rate.shape[0]
        return out

    @staticmethod
    def backward(ctx, go):
        spl, spd = ctx.saved_tensors
        gsl = go[..., None] * spl  # (M, nb, EVP)
        dbase = gsl.sum((0, 2))
        # d delta_k = sum of gsl over the configs holding spot k, from views
        # (the table stays on the host: no copy to the card per step)
        ddeltas = torch.zeros((ctx.Kf,) + tuple(gsl.shape[1:]), dtype=gsl.dtype,
                              device=gsl.device)
        for m, bits in enumerate(ctx.masks):
            for k in range(ctx.Kf):
                if (bits >> k) & 1:
                    ddeltas[k] += gsl[m]
        return None, dbase, ddeltas, _rate_grad(go, spd, ctx.R), None, None, None, None


def offset_gamma_factored_summed(value, base, deltas, mtab, rate,
                                 offset_samples, offset_logits, ev):
    """Event-summed offset-Gamma log-pdf over all spot-presence configs,
    with a_m = base + sum_k mtab[m, k] deltas[k] built inside the kernel, so
    no (M,) + batch + (EVP,) concentration is made (JAX:
    ``offset_gamma_factored_summed``).

    :param value: batch + (EVP,) lane-padded flat images.
    :param base: batch, per-image base concentration (no spots), > 0.
    :param deltas: (Kf,) + batch + (EVP,) per-spot contributions >= 0.
    :param mtab: (M, Kf) 0/1 host table (numpy array or nested sequence) of
        configs; on the card Kf <= 6 and M <= 64.
    :param rate: scalar tensor (the Gamma rate 1/gain), or (R,) per-chain
        rates over R equal runs of the images (see :func:`offset_gamma_summed`).
    :param ev: number of real pixels; the rest of EVP is masked.
    :return: (M,) + batch log-probabilities summed over each image's pixels.
    """
    if deltas.device.type == "cpu":
        return offset_gamma_factored_summed_plain(
            value, base, deltas, mtab, rate, offset_samples, offset_logits, ev
        )
    dtype = deltas.dtype
    Kf, batch, EVP = deltas.shape[0], tuple(deltas.shape[1:-1]), deltas.shape[-1]
    masks = config_masks(mtab, Kf)
    nb = math.prod(batch)
    x2 = value.to(dtype).reshape(nb, EVP).contiguous()
    b1 = base.to(dtype).reshape(nb).contiguous()
    d3 = deltas.reshape(Kf, nb, EVP).contiguous()
    g = offset_samples.to(dtype).contiguous()
    w = offset_logits.to(dtype).contiguous()
    rates = torch.as_tensor(rate, dtype=dtype, device=deltas.device).reshape(-1)
    if _wants_grad(b1, d3, rates):
        out = _FactoredFunction.apply(x2, b1, d3, rates, g, w, masks, int(ev))
    else:  # the JAX package's forward too runs the stats kernel and drops them
        out = factored_stats(x2, b1, d3, masks, rates, g, w, int(ev))[0]
    return out.reshape((len(masks),) + batch)
