"""Maximum-likelihood fits for kinetic analysis (counterpart of
tapqir_tpu/utils/mle_analysis.py).

The likelihoods are explicit torch functions of unconstrained parameters,
with the discrete "active" indicator summed out in closed form
(logaddexp), fitted by ``torch.optim.Adam`` (betas 0.9 / 0.999, eps 1e-8:
optax's defaults) for a fixed number of steps. Every row of the data is an
independent fit (its own parameters; Adam is elementwise), so the B rows
(posterior samples) are fitted at once. The fits run in float64 on the
device given (``None``: the CUDA card).
"""

from typing import Callable, Dict

import numpy as np
import torch

from tapqir_tpu_torch.device import resolve_device

__all__ = ["train", "ttfb_model_loss", "ttfb_mle", "exp_model_loss", "exp_mle"]


def train(loss_fn: Callable, params0: Dict[str, torch.Tensor], lr=1e-3,
          n_steps=1000):
    """Adam on ``loss_fn(params)`` from ``params0`` (tensors on the fit's
    device) for ``n_steps`` steps. Returns the final parameters and the
    loss before each step, as numpy."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    first = next(iter(params.values()))
    losses = torch.empty(n_steps, dtype=first.dtype, device=first.device)
    for i in range(n_steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params)
        loss.backward()
        opt.step()
        losses[i] = loss.detach()
    return ({k: v.detach().cpu().numpy() for k, v in params.items()},
            losses.cpu().numpy())


def _as_tensor(data, device):
    return torch.as_tensor(np.asarray(data), dtype=torch.float64, device=device)


def ttfb_model_loss(data, control, Tmax):
    r"""Negative log-likelihood of the time-to-first-binding model, Eq. 4
    and Eq. 7 of Friedman & Gelles 2015:
    p(tau) = Af Exp(ka + kns) + (1 - Af) Exp(kns), censored at Tmax; control
    locations follow Exp(kns) only.

    :param data: (B, N) tensor of ttfb at target locations.
    :param control: (B, Nc) tensor of ttfb at control locations, or None.
    :return: loss(params), params holding the unconstrained log_ka,
        log_kns, logit_Af of shape (B, 1).
    """
    mid = (data < Tmax) & (data > 0)
    tau = torch.where(mid, data, torch.ones_like(data))
    censored = data == Tmax
    if control is not None:
        midc = (control < Tmax) & (control > 0)
        tauc = torch.where(midc, control, torch.ones_like(control))
        censored_c = control == Tmax

    def exp_lp(k, tau, mid, censored):  # censored exponential log-density
        zero = torch.zeros((), dtype=k.dtype, device=k.device)
        return (torch.where(censored, -k * Tmax, zero)
                + torch.where(mid, torch.log(k) - k * tau, zero))

    def loss(params):
        ka = torch.exp(params["log_ka"])
        kns = torch.exp(params["log_kns"])
        Af = torch.sigmoid(params["logit_Af"])
        ll = torch.logaddexp(
            torch.log(Af) + exp_lp(ka + kns, tau, mid, censored),
            torch.log1p(-Af) + exp_lp(kns, tau, mid, censored),
        ).sum()
        if control is not None:
            ll = ll + exp_lp(kns, tauc, midc, censored_c).sum()
        return -ll

    return loss


def ttfb_mle(data, control, Tmax, lr=5e-3, n_steps=2000, device=None):
    """Fit ka, kns and Af per row of ``data`` (B, N) (and ``control``);
    returns (B, 1) constrained values and the losses."""
    dev = resolve_device(device)
    data_t = _as_tensor(data, dev)
    control_t = None if control is None else _as_tensor(control, dev)
    B = data_t.shape[0]
    params0 = {
        "log_ka": torch.full((B, 1), np.log(0.001), dtype=torch.float64, device=dev),
        "log_kns": torch.full((B, 1), np.log(0.001), dtype=torch.float64, device=dev),
        "logit_Af": torch.full((B, 1), np.log(0.9 / 0.1), dtype=torch.float64, device=dev),
    }
    params, losses = train(ttfb_model_loss(data_t, control_t, Tmax), params0,
                           lr=lr, n_steps=n_steps)
    return {
        "ka": np.exp(params["log_ka"]),
        "kns": np.exp(params["log_kns"]),
        "Af": 1 / (1 + np.exp(-params["logit_Af"])),
        "losses": losses,
    }


def exp_model_loss(data, K):
    r"""Negative log-likelihood of a K-exponential dwell-time mixture.

    :param data: (B, N) tensor of dwell times, zero-padded.
    """
    present = data > 0

    def loss(params):
        k = torch.exp(params["log_k"])  # (B, K)
        A = torch.softmax(params["logits_A"], dim=-1)  # (B, K)
        lp = (torch.log(A)[:, None, :] + torch.log(k)[:, None, :]
              - k[:, None, :] * data[..., None])  # (B, N, K)
        ll = torch.where(present, torch.logsumexp(lp, -1), torch.zeros_like(data))
        return -ll.sum()

    return loss


def exp_mle(data, K, lr=5e-3, n_steps=2000, device=None):
    """Fit a K-exponential mixture per row of ``data`` (B, N); returns k
    (B, K), A (B, K) and the losses."""
    dev = resolve_device(device)
    data_t = _as_tensor(data, dev)
    B = data_t.shape[0]
    log_k = torch.log(torch.logspace(-K + 1, 0, K, dtype=torch.float64, device=dev))
    params0 = {
        "log_k": log_k.expand(B, K).contiguous(),
        "logits_A": torch.zeros((B, K), dtype=torch.float64, device=dev),
    }
    params, losses = train(exp_model_loss(data_t, K), params0, lr=lr, n_steps=n_steps)
    A = np.exp(params["logits_A"])
    A = A / A.sum(-1, keepdims=True)
    return {"k": np.exp(params["log_k"]), "A": A, "losses": losses}
