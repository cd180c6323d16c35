"""Model registry (counterpart of tapqir_tpu/models/__init__.py)."""

from tapqir_tpu_torch.models.cosmos import cosmos
from tapqir_tpu_torch.models.crosstalk import crosstalk
from tapqir_tpu_torch.models.hmm import hmm
from tapqir_tpu_torch.models.model import Model

__all__ = ["models", "Model", "cosmos", "crosstalk", "hmm"]

models = {
    cosmos.name: cosmos,
    crosstalk.name: crosstalk,
    hmm.name: hmm,
}
