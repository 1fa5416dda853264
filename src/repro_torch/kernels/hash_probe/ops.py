"""Public entry point for the batched hash probe.

Dispatch by the tensors' device: a CUDA tensor launches the kernel, a CPU
tensor takes the plain version.  ``impl="reference"`` forces the plain
version on any device (the comparison in ``chip_smoke.py`` uses it).
"""

from __future__ import annotations

import torch

from . import kernel as _kernel
from . import ref as _ref


def hash_probe(table_keys: torch.Tensor, query_keys: torch.Tensor, *, impl: str | None = None):
    if impl == "reference" or (impl is None and not query_keys.is_cuda):
        return _ref.hash_probe_reference(table_keys, query_keys)
    if impl is not None:
        raise ValueError(f"unknown impl {impl!r}")
    return _kernel.hash_probe(table_keys, query_keys)
