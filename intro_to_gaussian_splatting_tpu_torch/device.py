"""Where the port runs: the CUDA card unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the card. Raises when a CUDA device is asked for and
    there is none: the port never carries on on the CPU by itself."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (or --cpu) to "
            "run on the host")
    return device
