"""The ELBO's per-spot dye tables: every spot's prior and guide
log-densities summed over the spots of each spot-presence config, their
three CUDA kernels (``csrc/spot_tables.cu``), and their plain PyTorch
version. cosmos and crosstalk take them in ``cosmos._dye_tables``,
cosmos+hmm in its per-frame tables.

For the (M, K) 0/1 config table ``mtab`` and each spot group (*lead, n, f,
Q) of K spots (``lead`` a leading chain axis, or none), :func:`spot_tables`
returns

* ``term_xy`` (M, *lead, 1+K, n, f, Q): sum_k mtab[m, k] (log p(x_k) + log
  p(y_k)), the positions' prior centred on the target (AffineBeta(0, size),
  size = ((P + 1) / (2 proximity))^2 - 1, each chain its own) where
  ``spec_tk[t, k]`` (theta = t makes spot k the specific one), else uniform;
* ``term_hw`` (M, *lead, n, f, Q): sum_k mtab[m, k] (log p(h_k) + log
  p(w_k));
* ``term_q`` (M, *lead, n, f, Q): sum_k mtab[m, k] log q(h_k, w_k, x_k,
  y_k);
* ``log_qm`` (M, *lead, [Z,] n, f, Q): sum_k mtab[m, k] log qm_k + (1 -
  mtab[m, k]) log1p(-qm_k), with the z axis exactly when ``qm`` carries one
  (cosmos+hmm's q(m | z)).

On CUDA tensors the forward is one launch of ``spot_tables`` and the
backward one of ``spot_tables_grad`` and one of ``spot_tables_prox`` (each
chain's proximity gradient summed in a fixed order); their launch counts
are on those launchers. CPU tensors take :func:`spot_tables_plain`, the
composition op by op. There is no fallback from one to the other.
"""

import ctypes
import functools
import math

import torch

from tapqir_tpu_torch.csrc import native
from tapqir_tpu_torch.distributions.core import (
    affine_beta_log_prob,
    gamma_log_prob,
    halfnormal_log_prob,
)
from tapqir_tpu_torch.ops.offset_gamma import config_masks

# the per-spot inputs, in the kernels' order
INPUTS = ("xs", "ys", "h", "w", "qm", "h_loc", "h_beta", "w_mean", "w_size", "x_mean",
          "y_mean", "size")
_QM = INPUTS.index("qm")


def spot_tables_plain(xs, ys, h, w, qm, h_loc, h_beta, w_mean, w_size, x_mean, y_mean, size,
                      prox, mtab, spec_tk, P, priors):
    """:func:`spot_tables` op by op."""
    mtab = torch.as_tensor(mtab, dtype=xs.dtype, device=xs.device)
    spec_tk = torch.as_tensor(spec_tk, device=xs.device)
    lim = (P + 1) / 2
    wmin, wmax = priors["width_min"], priors["width_max"]

    size_sp = ((P + 1) / (2 * prox)) ** 2 - 1.0
    size_sp = size_sp.reshape(size_sp.shape + (1,) * 4)  # against (n, f, Q, K)
    lpxy_ns = affine_beta_log_prob(xs, 0.0, 2.0, -lim, lim) + affine_beta_log_prob(
        ys, 0.0, 2.0, -lim, lim
    )  # (*lead, n, f, Q, K)
    lpxy_sp = affine_beta_log_prob(
        xs, 0.0, size_sp, -lim, lim
    ) + affine_beta_log_prob(ys, 0.0, size_sp, -lim, lim)
    lpxy_t = torch.where(
        spec_tk[:, None, None, None, :], lpxy_sp.unsqueeze(-5), lpxy_ns.unsqueeze(-5)
    )  # (*lead, 1+K, n, f, Q, K)
    term_xy = torch.einsum("mk,...tnfqk->m...tnfq", mtab, lpxy_t)  # (M, *lead, 1+K, n, f, Q)

    lph = halfnormal_log_prob(h, priors["height_std"])
    lpw = affine_beta_log_prob(w, 1.5, 2.0, wmin, wmax)
    term_hw = torch.einsum("mk,...nfqk->m...nfq", mtab, lph + lpw)

    sub = "mk,...snfqk->m...snfq" if qm.dim() > xs.dim() else "mk,...nfqk->m...nfq"
    log_qm = torch.einsum(sub, mtab, torch.log(qm)) + torch.einsum(
        sub, 1.0 - mtab, torch.log1p(-qm)
    )
    lqh = gamma_log_prob(h, h_loc * h_beta, h_beta)
    lqw = affine_beta_log_prob(w, w_mean, w_size, wmin, wmax)
    lqx = affine_beta_log_prob(xs, x_mean, size, -lim, lim)
    lqy = affine_beta_log_prob(ys, y_mean, size, -lim, lim)
    term_q = torch.einsum("mk,...nfqk->m...nfq", mtab, lqh + lqw + lqx + lqy)
    return term_xy, term_hw, term_q, log_qm


# ---------------------------------------------------------------------------
# the library and its launchers
# ---------------------------------------------------------------------------

_ptr, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# inputs (host array of 13: the 12 of INPUTS, prox), their strides (host, 12 x 4),
# R, G, Z, K, masks (host), M, spec (host), NT, constants (host)
_COMMON = [_ptr, _ptr, _i64, _i64, _i32, _i32, _ptr, _i32, _ptr, _i32, _ptr]
library = native.Library(
    "spot_tables.cu", "spot_tables",
    {"st_tables": _COMMON + [_ptr, _ptr],  # tables (host array of 4), stream
     # cotangents (host array of 4), gradients (host array of 12), their strides, partials, stream
     "st_tables_grad": _COMMON + [_ptr, _ptr, _ptr, _ptr, _ptr],
     # partials, prox, R, blocks a chain, P + 1, d prox, stream
     "st_prox_sum": [_ptr, _ptr, _i64, _i64, ctypes.c_double, _ptr, _ptr]},
    probes=("st_max_spots", "st_block_threads"),
)


@functools.lru_cache(maxsize=None)
def _constants(P, wmin, wmax, height_std):
    """The kernels' constants, in ``csrc/spot_tables.cu``'s ``Const`` order."""
    lim = (P + 1) / 2
    pw1 = 2.0 * (1.5 - wmin) / (wmax - wmin)  # the width prior, AffineBeta(1.5, 2)
    pw0 = 2.0 * (wmax - 1.5) / (wmax - wmin)
    values = (-lim, lim, lim - (-lim), math.log(lim - (-lim)), wmin, wmax, wmax - wmin,
              math.log(wmax - wmin), pw1 - 1.0, pw0 - 1.0,
              math.lgamma(pw1 + pw0) - math.lgamma(pw1) - math.lgamma(pw0)
              - math.log(wmax - wmin),
              0.5 * math.log(2.0 / math.pi) - math.log(height_std), height_std, float(P + 1))
    return (ctypes.c_double * len(values))(*values)


def _strides(views):
    """(host array) the (R, Z, G, K) strides of each view."""
    return (ctypes.c_longlong * (4 * len(views)))(*(s for v in views for s in v.stride()))


class _Launcher(native.Kernel):
    """The forward (``grad`` False) or the backward of the tables over the
    12 inputs of INPUTS as (R, Z, G, K) views (Z = 1 but for ``qm``) and
    ``prox`` (R,)."""

    def __init__(self, name, entry, grad):
        super().__init__(name, library, entry)
        self.grad = grad

    def __call__(self, views, prox, masks, spec, consts, outs=None, gos=None, grads=None):
        """The forward writes ``outs``: term_xy (M, R, NT, G), term_hw and
        term_q (M, R, G), log_qm (M, R, Z, G). The backward reads ``gos``
        (the four tables' gradients, as ``outs``) and writes ``grads`` (the
        views' gradients, each of its view's shape); it returns the per-block
        partials (R, blocks) that :data:`prox_sum` takes."""
        like = views[0]
        fn = self.function(like)
        R, _, G, K = like.shape
        Z = views[_QM].shape[1]
        M, NT = len(masks), len(spec)
        if not 1 <= K <= library.limits["st_max_spots"] or M > 1 << K or NT != 1 + K:
            raise ValueError(f"{K} spots, {M} configs and {NT} theta states: the kernel takes "
                             f"at most {library.limits['st_max_spots']} spots")
        shape = [(R, Z if i == _QM else 1, G, K) for i in range(len(INPUTS))]
        tables = [(M, R, NT, G), (M, R, G), (M, R, G), (M, R, Z, G)]
        native.check_tensors([prox], like, [(R,)])
        native.check_tensors(views, like, shape, contiguous=False)
        ptrs = (ctypes.c_void_p * 13)(*[t.data_ptr() for t in views], prox.data_ptr())
        args = (ptrs, _strides(views), R, G, Z, K, (ctypes.c_uint * M)(*masks), M,
                (ctypes.c_uint * NT)(*spec), NT, consts)
        if not self.grad:
            native.check_tensors(outs, like, tables)
            self.launch(fn, like, *args, (ctypes.c_void_p * 4)(*[t.data_ptr() for t in outs]))
            return None
        native.check_tensors(gos, like, tables)
        native.check_tensors(grads, like, shape, contiguous=False)
        blocks = -(-G // library.limits["st_block_threads"])
        part = like.new_empty((R, blocks))
        self.launch(fn, like, *args, (ctypes.c_void_p * 4)(*[t.data_ptr() for t in gos]),
                    (ctypes.c_void_p * 12)(*[t.data_ptr() for t in grads]), _strides(grads),
                    part.data_ptr())
        return part


class _ProxSum(native.Kernel):
    """Each chain's proximity gradient from the backward's partials."""

    def __call__(self, part, prox, P):
        fn = self.function(part)
        R, blocks = part.shape
        native.check_tensors([part, prox], part, [(R, blocks), (R,)])
        out = torch.empty_like(prox)
        self.launch(fn, part, part.data_ptr(), prox.data_ptr(), R, blocks, float(P + 1),
                    out.data_ptr())
        return out


tables = _Launcher("spot_tables", "st_tables", grad=False)  # the four tables, in the forward
tables_grad = _Launcher("spot_tables_grad", "st_tables_grad", grad=True)  # their gradients
prox_sum = _ProxSum("spot_tables_prox", library, "st_prox_sum")  # the proximity's


class _TablesFunction(torch.autograd.Function):
    """The three kernels as one autograd node; the backward reads the saved
    inputs again, so no intermediate of the forward is kept."""

    @staticmethod
    def forward(ctx, prox, masks, spec, P, priors, *views):
        like = views[0]
        R, _, G, K = like.shape
        Z, M, NT = views[_QM].shape[1], len(masks), len(spec)
        consts = _constants(P, priors["width_min"], priors["width_max"], priors["height_std"])
        outs = (like.new_empty((M, R, NT, G)), like.new_empty((M, R, G)),
                like.new_empty((M, R, G)), like.new_empty((M, R, Z, G)))
        tables(views, prox, masks, spec, consts, outs=outs)
        ctx.save_for_backward(prox, *views)
        ctx.args = masks, spec, P, consts
        return outs

    @staticmethod
    def backward(ctx, *gos):
        prox, *views = ctx.saved_tensors
        masks, spec, P, consts = ctx.args
        grads = [torch.empty_like(v) for v in views]
        part = tables_grad(views, prox, masks, spec, consts,
                           gos=[g.contiguous() for g in gos], grads=grads)
        return (prox_sum(part, prox, P), None, None, None, None, *grads)


def spot_tables(xs, ys, h, w, qm, h_loc, h_beta, w_mean, w_size, x_mean, y_mean, size, prox,
                mtab, spec_tk, P, priors):
    """The dye tables ``(term_xy, term_hw, term_q, log_qm)`` of the module
    docstring.

    :param xs, ys, h, w: (*lead, n, f, Q, K) spot samples.
    :param qm: (*lead, [Z,] n, f, Q, K) q(m_k = 1 [| z]).
    :param h_loc, h_beta, w_mean, w_size, x_mean, y_mean, size: (*lead, n,
        f, Q, K) the guide's parameters of the spot sites.
    :param prox: () or (R,) with ``lead == (R,)``: each chain's proximity.
    :param mtab: (M, K) 0/1 host table (numpy array or nested sequence) of
        configs; on the card K <= 6.
    :param spec_tk: (1+K, K) boolean host table, theta = t makes spot k
        specific.
    :param P: the image's side; ``priors``: the model's priors
        (``width_min``, ``width_max``, ``height_std``).
    """
    spots = (xs, ys, h, w, qm, h_loc, h_beta, w_mean, w_size, x_mean, y_mean, size)
    if xs.device.type == "cpu":
        return spot_tables_plain(*spots, prox, mtab, spec_tk, P, priors)
    lead = tuple(prox.shape)
    c, K = len(lead), xs.shape[-1]
    group = tuple(xs.shape[c:-1])
    z = tuple(qm.shape[c:c + 1]) if qm.dim() == xs.dim() + 1 else ()
    if len(lead) > 1 or tuple(xs.shape[:c]) != lead or len(group) != 3:
        raise ValueError(f"spots {tuple(xs.shape)} for a proximity {lead}: the kernel takes "
                         "(*lead, n, f, Q, K) with lead () or (R,)")
    for name, t in zip(INPUTS, spots):
        want = lead + (z if name == "qm" else ()) + group + (K,)
        if tuple(t.shape) != want:
            raise ValueError(f"{name} {tuple(t.shape)} where the kernel takes {want}")
    R, G, Z = math.prod(lead), math.prod(group), math.prod(z)
    views = [t.reshape(R, Z if name == "qm" else 1, G, K) for name, t in zip(INPUTS, spots)]
    spec = tuple(int(sum(1 << k for k, s in enumerate(row) if s)) for row in spec_tk)
    outs = _TablesFunction.apply(prox.reshape(R), config_masks(mtab, K), spec, P, priors,
                                 *views)
    M = len(outs[0])
    return (outs[0].view((M,) + lead + (len(spec),) + group),
            outs[1].view((M,) + lead + group), outs[2].view((M,) + lead + group),
            outs[3].view((M,) + lead + z + group))
