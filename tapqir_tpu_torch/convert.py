"""Conversion of the JAX package's training state into the port's tensors.

Both packages keep the same unconstrained parameterization and the same
checkpoint keys (``p::``, ``mu::``, ``nu::``, ``count::``, ``rng::key``,
``meta``), so a checkpoint written by one is resumed by the other through
``Model.load_checkpoint``. These helpers do the same for state held in
memory as dicts of numpy arrays (for example ``jax.device_get`` of a JAX
model's ``params`` and Adam state).
"""

import numpy as np
import torch


def _tensor(v, device, dtype=None):
    t = torch.as_tensor(np.array(v))  # a copy: JAX arrays are read-only
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def params_from_jax(params_np: dict, device, dtype=None) -> dict:
    """Unconstrained parameters (name -> numpy array) as port tensors; the
    dtype defaults to the arrays' own floating type."""
    return {k: _tensor(v, device, dtype) for k, v in params_np.items()}


def opt_state_from_jax(mu_np: dict, nu_np: dict, count_np, device,
                       dtype=None) -> dict:
    """Adam state as the port's ``opt_state``: the moments ``mu``/``nu``
    (name -> array) and the step counts - either the sparse per-row-group
    dict (``"g"``, ``"a"``, ``"af"``) or one dense scalar count, which is
    not converted here (``Model.load_checkpoint`` expands it)."""
    if not isinstance(count_np, dict):
        raise ValueError("expected the sparse Adam counts as a dict of arrays")
    return {
        "mu": params_from_jax(mu_np, device, dtype),
        "nu": params_from_jax(nu_np, device, dtype),
        "count": {k: _tensor(v, device, torch.int32) for k, v in count_np.items()},
    }
