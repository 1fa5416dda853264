"""Public entry point for the batched frontier expansion.

Dispatch by the tensors' device: a CUDA tensor launches the kernel, a CPU
tensor takes the plain version.  ``impl="reference"`` forces the plain
version on any device (the comparison in ``chip_smoke.py`` uses it), and
``impl="kernel"`` the kernel, which refuses tensors that are not on the
card.
"""

from __future__ import annotations

import torch

from . import kernel as _kernel
from . import ref as _ref


def frontier_expand(
    frontier: torch.Tensor, src: torch.Tensor, dst: torch.Tensor, *, impl: str | None = None
) -> torch.Tensor:
    if impl == "reference" or (impl is None and not frontier.is_cuda):
        return _ref.frontier_expand_reference(frontier, src, dst)
    if impl not in (None, "kernel"):
        raise ValueError(f"unknown impl {impl!r}")
    return _kernel.frontier_expand(frontier, src, dst)
