"""tapqir-tpu-torch: the PyTorch/CUDA port of tapqir_tpu for NVIDIA Hopper.

Same models, parameterization, checkpoint and data formats as the JAX
package beside it; plain tensor code is PyTorch, and the offset-marginalized
Gamma likelihood runs in a CUDA kernel written for sm_90a
(``csrc/offset_gamma.cu``). Entry points run on ``cuda:0`` unless the caller
passes ``device="cpu"``; without a card and without that request they raise.
"""

__version__ = "0.1.0"

from tapqir_tpu_torch.exceptions import (  # noqa: F401
    CudaOutOfMemoryError,
    TapqirException,
    TapqirFileNotFoundError,
)
