"""Distribution layer (counterpart of tapqir_tpu/distributions)."""

from tapqir_tpu_torch.distributions import core  # noqa: F401
from tapqir_tpu_torch.distributions.core import (  # noqa: F401
    affine_beta_log_prob,
    affine_beta_sample,
    beta_log_prob,
    beta_sample,
    bernoulli_log_prob,
    dirichlet_log_prob,
    dirichlet_sample,
    exponential_log_prob,
    exponential_sample,
    gamma_log_prob,
    gamma_sample,
    halfnormal_log_prob,
    halfnormal_sample,
)
from tapqir_tpu_torch.distributions.ksmogn import (  # noqa: F401
    KSMOGN,
    ksmogn_image,
    ksmogn_log_prob,
    ksmogn_sample,
    offset_gamma_factored_summed,
    offset_gamma_log_prob,
    offset_gamma_log_prob_summed,
)
from tapqir_tpu_torch.distributions.util import (  # noqa: F401
    expand_offtarget,
    gaussian_spots,
    gaussian_spots_flat,
    probs_m,
    probs_theta,
    truncated_poisson_probs,
)
