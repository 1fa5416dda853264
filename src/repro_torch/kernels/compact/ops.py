"""Public entry points for the compaction primitives.

Dispatch by the tensors' device: a CUDA tensor launches the kernel, a CPU
tensor takes the plain version.  ``impl="reference"`` forces the plain
version on any device (the comparison in ``chip_smoke.py`` uses it).
"""

from __future__ import annotations

import torch

from . import kernel as _kernel
from . import ref as _ref


def _use_reference(impl: str | None, t: torch.Tensor) -> bool:
    if impl == "reference" or (impl is None and not t.is_cuda):
        return True
    if impl is not None:
        raise ValueError(f"unknown impl {impl!r}")
    return False


def masked_compact(
    values: torch.Tensor, mask: torch.Tensor, *, fill: int, impl: str | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    if _use_reference(impl, values):
        return _ref.masked_compact_reference(values, mask, fill=fill)
    return _kernel.masked_compact(values, mask, fill=fill)


def probe_place(
    home: torch.Tensor,
    active: torch.Tensor,
    *,
    capacity: int,
    max_probes: int,
    impl: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    if _use_reference(impl, home):
        return _ref.probe_place_reference(
            home, active, capacity=capacity, max_probes=max_probes
        )
    return _kernel.probe_place(home, active, capacity=capacity, max_probes=max_probes)
