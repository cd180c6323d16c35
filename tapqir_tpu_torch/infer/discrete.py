"""Closed-form discrete marginalization helpers (counterpart of
tapqir_tpu/infer/discrete.py): dense tables over z, theta and m."""

import numpy as np
import torch

from tapqir_tpu_torch.distributions.util import expand_offtarget, probs_m

# Large-but-finite stand-in for log(0): keeps every gradient finite
NEG_INF = -1e30


def safe_log(p, floor=1e-30):
    """log with a floor; for probabilities that may be exactly zero."""
    return torch.log(torch.clamp(p, min=floor))


def m_configs(K: int) -> np.ndarray:
    """All 2^K spot-presence configurations as a static (2^K, K) 0/1 table."""
    M = 1 << K
    return np.array([[(m >> k) & 1 for k in range(K)] for m in range(M)], np.float64)


def log_probs_theta(K: int, S: int, dtype=torch.float32, device=None):
    """log p(theta | z) as a dense (1+S, 1+K) table; invalid combos -> NEG_INF.
    Rows for z > 0 all use the spot-present distribution."""
    tab = np.zeros((2, 1 + K))
    tab[0, 0] = 1.0
    tab[1, 1:] = 1.0 / K
    tab_full = np.stack([tab[0]] + [tab[1]] * S)  # (1+S, 1+K)
    out = np.where(tab_full > 0, np.log(np.maximum(tab_full, 1e-300)), NEG_INF)
    return torch.as_tensor(out, dtype=dtype, device=device)


def select_ontarget(table, is_ontarget):
    """Each AOI's slice of a table indexed last by is_ontarget: ``table``
    (*lead, *E, 2) and ``is_ontarget`` (*lead, n) integer {0, 1} give
    (*lead, n, *E), ``lead`` a leading chain axis or none."""
    c = is_ontarget.dim() - 1
    on, off = table[..., 1].unsqueeze(c), table[..., 0].unsqueeze(c)
    cond = (is_ontarget == 1).reshape(tuple(is_ontarget.shape) + (1,) * (on.dim() - c - 1))
    return torch.where(cond, on, off)


def log_probs_z(pi, is_ontarget):
    """log p(z | pi, is_ontarget) of shape (n, Q, 1+S); off-target AOIs are
    forced into z=0.

    :param pi: (Q, 1+S) state probabilities, or (R, Q, 1+S) per chain.
    :param is_ontarget: (n,) integer {0,1} tensor, or (R, n) per chain.
    """
    return select_ontarget(safe_log(expand_offtarget(pi)), is_ontarget)


def log_probs_m(lamda, K: int):
    """(log p(m_k=1 | theta), log p(m_k=0 | theta)) tables, each (..., 1+K, K).
    The deterministic entries (theta == k+1 -> m_k = 1) use a static mask so
    gradients with respect to lamda stay finite."""
    pm = probs_m(lamda, K)  # (..., 1+K, K)
    eye = torch.cat(
        [
            torch.zeros((1, K), dtype=torch.bool, device=lamda.device),
            torch.eye(K, dtype=torch.bool, device=lamda.device),
        ],
        dim=0,
    )
    pm_safe = torch.where(eye, 0.5, torch.clamp(pm, 1e-30, 1.0 - 1e-7))
    log1 = torch.where(eye, 0.0, torch.log(pm_safe))
    log0 = torch.where(eye, NEG_INF, torch.log1p(-pm_safe))
    return log1, log0
