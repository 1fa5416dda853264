"""Launch wrapper for the CUDA frontier expansion (``csrc/frontier.cu``).

Replaces the Pallas kernel ``repro/kernels/frontier/kernel.py::frontier_expand``.
The note on what bounds it and how it is laid out is in the CUDA source.
"""

from __future__ import annotations

import torch

from .. import _build
from .ref import NBR_INF


def frontier_expand(
    frontier: torch.Tensor, src: torch.Tensor, dst: torch.Tensor
) -> torch.Tensor:
    """i32[S, C] for CUDA tensors: min frontier source slot over in-edges,
    NBR_INF where none.  ``src``/``dst`` values must lie in ``[0, C)``."""
    _build.require_cuda("frontier_expand", frontier, src, dst)
    if frontier.dtype != torch.bool or src.dtype != torch.int32 or dst.dtype != torch.int32:
        raise TypeError("frontier_expand: frontier bool, src/dst int32")
    if frontier.dim() != 2 or src.dim() != 1 or src.shape != dst.shape:
        raise ValueError("frontier_expand: frontier [S, C], src/dst [Ce]")
    n_src, c = frontier.shape
    out = torch.full((n_src, c), NBR_INF, dtype=torch.int32, device=frontier.device)
    code = _build.library().rt_frontier_expand(
        frontier.view(torch.uint8).data_ptr(), n_src, c, src.data_ptr(),
        dst.data_ptr(), src.shape[0], out.data_ptr(), _build.stream_ptr(frontier),
    )
    _build.check(code, "rt_frontier_expand")
    frontier_expand.launches += 1
    frontier_expand.calls += 1
    return out


frontier_expand.launches = 0
frontier_expand.calls = 0
