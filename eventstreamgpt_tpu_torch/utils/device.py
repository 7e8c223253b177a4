"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device, what: str) -> torch.device:
    """``None`` means the CUDA device; there is no silent CPU fallback.

    ``what`` names the entry point in the error raised when no CUDA device
    is available.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on a CUDA device by default and none is available; "
                "pass device='cpu' to run the plain PyTorch versions of the kernels on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
