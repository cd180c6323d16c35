"""Simulate datasets from the generative models (counterpart of
tapqir_tpu/utils/simulate.py).

Ancestral sampling on the chosen device with a ``torch.Generator`` seeded
from ``seed``: fixed physical parameters in, CosmosDataset with ground-truth
z labels out. The regime is selected by the keys of ``params``:

* ``pi``                -> time-independent cosmos states
* ``alpha`` (+ ``pi``)  -> crosstalk (Q dyes bleeding into C channels)
* ``kon``/``koff`` or ``init``/``trans`` -> kinetic (HMM) state chain

Torch's generator cannot reproduce JAX's draws, so datasets differ from the
JAX simulator's for the same seed; they follow the same distributions.
"""

from typing import Optional

import numpy as np
import torch

from tapqir_tpu_torch.device import resolve_device
from tapqir_tpu_torch.distributions.core import affine_beta_sample
from tapqir_tpu_torch.distributions.ksmogn import ksmogn_sample
from tapqir_tpu_torch.distributions.util import probs_m
from tapqir_tpu_torch.utils.dataset import CosmosDataset, OffsetData

__all__ = ["simulate"]


def _categorical(gen, probs):
    """One index per row of ``probs`` (..., S)."""
    flat = probs.reshape(-1, probs.shape[-1])
    return torch.multinomial(flat, 1, generator=gen).reshape(probs.shape[:-1])


def _sample_z_iid(gen, pi, N, F, Q, is_ontarget):
    """z ~ Bernoulli(pi) for on-target AOIs, 0 for off-target."""
    p = torch.full((N, F, Q), pi, device=is_ontarget.device)
    z = torch.bernoulli(p, generator=gen).long()
    return torch.where(is_ontarget[:, None, None], z, 0)


def _sample_z_markov(gen, init, trans, N, F, Q, is_ontarget):
    """z_0 ~ init; z_f ~ trans[z_{f-1}], vectorized over AOIs and dyes."""
    z = torch.empty((N, F, Q), dtype=torch.long, device=init.device)
    z[:, 0] = _categorical(gen, init.expand(N, Q, init.shape[-1]))
    qdx = torch.arange(Q, device=init.device)
    for f in range(1, F):
        z[:, f] = _categorical(gen, trans[qdx[None, :], z[:, f - 1]])
    return torch.where(is_ontarget[:, None, None], z, 0)


def simulate(
    model: str,
    N: int,
    F: int,
    C: int = 1,
    P: int = 14,
    seed: int = 0,
    params: Optional[dict] = None,
    K: int = 2,
    device=None,
) -> CosmosDataset:
    """Simulate a new dataset (reference: tapqir/utils/simulate.py:12-138).

    :param N: total AOIs; the first half is on-target, second half off-target.
    :param params: gain, lamda, proximity, offset, height, background, width,
        plus one of {pi}, {alpha, pi}, {kon, koff} or {init, trans}.
    :param device: where to sample; ``None`` means ``cuda:0``.
    """
    del model  # regime is determined by params keys, as in the reference
    params = dict(params or {})
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    Q = C
    f32 = torch.float32

    is_ontarget = np.zeros((N,), dtype=bool)
    is_ontarget[: N // 2] = True
    ont = torch.as_tensor(is_ontarget, device=dev)

    gain = float(params["gain"])
    lamda = torch.full((Q,), float(params["lamda"]), dtype=f32, device=dev)
    proximity = float(params["proximity"])
    offset_val = float(params["offset"])

    # --- discrete states ----------------------------------------------------
    if ("kon" in params and "koff" in params) or ("init" in params and "trans" in params):
        if "kon" in params:
            kon, koff = float(params["kon"]), float(params["koff"])
            init = torch.tensor(
                [koff / (kon + koff), kon / (kon + koff)], dtype=f32, device=dev
            ).expand(Q, 2)
            trans = torch.tensor(
                [[1 - kon, kon], [koff, 1 - koff]], dtype=f32, device=dev
            ).expand(Q, 2, 2)
        else:
            init = torch.as_tensor(np.asarray(params["init"]), dtype=f32,
                                   device=dev).reshape(Q, -1)
            S1 = init.shape[-1]
            trans = torch.as_tensor(np.asarray(params["trans"]), dtype=f32,
                                    device=dev).reshape(Q, S1, S1)
        z = _sample_z_markov(gen, init, trans, N, F, Q, ont)
    else:
        z = _sample_z_iid(gen, float(params["pi"]), N, F, Q, ont)

    # --- theta | z: z=0 -> theta=0; z>0 -> uniform over {1..K} ---------------
    theta_pos = 1 + torch.randint(0, K, (N, F, Q), generator=gen, device=dev)
    theta = torch.where(z > 0, theta_pos, 0)

    # --- m | theta, lamda ----------------------------------------------------
    pm_table = probs_m(lamda, K)  # (Q, 1+K, K)
    qdx = torch.arange(Q, device=dev)
    kdx = torch.arange(K, device=dev)
    pm = pm_table[qdx[None, None, :, None], theta[..., None], kdx]  # (N,F,Q,K)
    m = torch.bernoulli(pm, generator=gen)

    # --- spot shapes ----------------------------------------------------------
    size_sp = ((P + 1) / (2 * proximity)) ** 2 - 1
    spec = theta[..., None] == 1 + kdx  # (N, F, Q, K)
    size = torch.where(
        spec, torch.tensor(size_sp, dtype=f32, device=dev),
        torch.tensor(2.0, dtype=f32, device=dev),
    )
    lim = (P + 1) / 2
    x = affine_beta_sample(0.0, size, -lim, lim, gen)
    y = affine_beta_sample(0.0, size, -lim, lim, gen)
    h = torch.full((N, F, Q, K), float(params["height"]), dtype=f32, device=dev)
    w = torch.full((N, F, Q, K), float(params["width"]), dtype=f32, device=dev)
    b = torch.full((N, F, C), float(params["background"]), dtype=f32, device=dev)
    target_locs = torch.full((N, F, C, 2), (P - 1) / 2, dtype=f32, device=dev)

    offset_samples = torch.full((3,), offset_val, dtype=f32, device=dev)
    offset_logits = torch.log(torch.ones(3, dtype=f32, device=dev) / 3)

    # --- images ----------------------------------------------------------------
    alpha = None
    if "alpha" in params:
        alpha = torch.as_tensor(np.asarray(params["alpha"]), dtype=f32,
                                device=dev).reshape(Q, C)
    with torch.no_grad():
        data = ksmogn_sample(
            gen, h, w, x, y, target_locs, b, gain,
            offset_samples, offset_logits, P, m, alpha,
        )
    data = torch.floor(data)

    # --- ground-truth labels (on-target half) ----------------------------------
    n_lab = N // 2
    labels = np.zeros((n_lab, F, Q), dtype=[("aoi", int), ("frame", int), ("z", int)])
    labels["aoi"] = np.arange(n_lab).reshape(-1, 1, 1)
    labels["frame"] = np.arange(F).reshape(-1, 1)
    labels["z"] = z[:n_lab].cpu().numpy()

    return CosmosDataset(
        images=data.cpu().numpy().astype(np.float32),
        xy=target_locs.cpu().numpy(),
        is_ontarget=is_ontarget,
        labels=labels,
        offset=OffsetData(
            np.full((3,), offset_val, np.float64), np.ones(3, np.float64) / 3
        ),
        name="simulated",
    )
