"""Device and dtype resolution shared by the port's entry points."""

import torch

_DTYPES = {
    "float": torch.float32,
    "float32": torch.float32,
    "single": torch.float32,
    "double": torch.float64,
    "float64": torch.float64,
}


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda:0``. The CPU is used only when asked for by
    name; without a card any other request raises (no silent fallback)."""
    if device is None:
        device = "cuda:0"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def resolve_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise ValueError(
            f"unsupported dtype {dtype!r}; choose from {sorted(_DTYPES)}"
        )
    return _DTYPES[dtype]
