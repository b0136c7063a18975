"""Where the port runs: on the CUDA card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Without a card and without an explicit device this raises instead of
    running quietly on the CPU: pass ``device="cpu"`` for the plain
    versions of the kernels.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work; a no-op on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
