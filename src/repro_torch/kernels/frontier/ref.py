"""Plain PyTorch version of one BFS frontier expansion.

Every edge lane whose *source* slot is on the frontier proposes its source
slot as the parent of its *destination* slot, and each destination keeps the
minimum proposer: one gather plus one ``scatter_reduce_("amin")`` over
``dst`` broadcast to every source row.
"""

from __future__ import annotations

import torch

from ...core.types import INT32_MAX

# "no in-frontier neighbor" sentinel: larger than any slot index.
NBR_INF = INT32_MAX


def frontier_expand_reference(
    frontier: torch.Tensor,  # bool[S, C] — per-source frontier masks
    src: torch.Tensor,       # i32[Ce] — edge source slots, values in [0, C)
    dst: torch.Tensor,       # i32[Ce] — edge destination slots, values in [0, C)
) -> torch.Tensor:
    """i32[S, C]: min frontier source slot over in-edges, NBR_INF where none."""
    n_src = frontier.shape[0]
    cand = torch.where(frontier[:, src.long()], src[None, :], NBR_INF)
    out = torch.full(frontier.shape, NBR_INF, dtype=torch.int32, device=frontier.device)
    return out.scatter_reduce_(1, dst.long()[None, :].expand(n_src, -1), cand, "amin")
