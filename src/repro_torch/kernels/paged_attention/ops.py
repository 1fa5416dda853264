"""Public entry point for paged decode attention.

Dispatch by the tensors' device: a CUDA tensor launches the kernel, a CPU
tensor takes the plain version (``ref.paged_attention_reference``).  The
block table and lengths may lie on the host for a ``q`` on the card: the
kernel's wrapper then checks them there and reads nothing back from the
device, and the plain version gets them on q's device.
``impl="reference"`` forces the plain version on any device (the comparison
in ``chip_smoke.py`` uses it).  Both give 0 for a sequence of length 0, as
``repro``'s Pallas kernel does.
"""

from __future__ import annotations

import torch

from . import kernel as _kernel
from . import ref as _ref


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_table: torch.Tensor, seq_lens: torch.Tensor, *,
                    sm_scale: float | None = None, impl: str | None = None) -> torch.Tensor:
    """q (B, Hq, D); k_pages, v_pages (P, page_size, Hkv, D); block_table
    (B, pages_per_seq) int32; seq_lens (B,) int32 -> (B, Hq, D) in q's
    dtype."""
    if impl == "reference" or (impl is None and not q.is_cuda):
        # host tables for a q on the card go where q is
        return _ref.paged_attention_reference(q, k_pages, v_pages, block_table.to(q.device),
                                              seq_lens.to(q.device), sm_scale=sm_scale)
    if impl is not None:
        raise ValueError(f"unknown impl {impl!r}")
    return _kernel.paged_attention(q, k_pages, v_pages, block_table, seq_lens, sm_scale=sm_scale)
