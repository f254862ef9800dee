"""Device choice for the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the CUDA card, and raises when CUDA is absent: an entry
    point never moves to the host on its own. Pass ``"cpu"`` to ask for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the host"
            )
        return torch.device("cuda")
    return torch.device(device)
