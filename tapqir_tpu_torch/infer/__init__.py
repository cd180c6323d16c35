"""Inference helpers (counterpart of tapqir_tpu/infer)."""

from tapqir_tpu_torch.infer.discrete import (  # noqa: F401
    NEG_INF,
    log_probs_m,
    log_probs_theta,
    log_probs_z,
    m_configs,
    safe_log,
)
