"""Where the port's entry points run: on the card unless the caller asks."""

from __future__ import annotations

import torch


def resolve_device(device, who: str) -> torch.device:
    """``device``, or ``cuda`` when it is None; raises where no card is
    present rather than falling back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who} runs on the card by default and no CUDA device is available; "
                "pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)
