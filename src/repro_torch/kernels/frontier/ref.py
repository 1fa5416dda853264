"""Plain PyTorch version of one BFS frontier expansion.

Every edge lane whose *source* slot is on the frontier proposes its source
slot as the parent of its *destination* slot, and each destination keeps the
minimum proposer: one gather plus one ``scatter_reduce_("amin")`` over
``dst`` broadcast to every source row.  :func:`frontier_expand_packed`
mirrors the CUDA kernel's two passes (pack to bits, expand over set bits)
for the tests; nothing on the main path calls it.
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


def frontier_expand_packed(
    frontier: torch.Tensor,  # bool[S, C]
    src: torch.Tensor,       # i32[Ce], values in [0, C)
    dst: torch.Tensor,       # i32[Ce], values in [0, C)
) -> torch.Tensor:
    """The CUDA kernel's decomposition in plain PyTorch, for the tests: pack
    the frontier into ceil(S / 32) words a column, one bit a source row,
    then one ``scatter_reduce_("amin")`` of ``src[e]`` into the flat output
    at ``s * C + dst[e]`` for every set bit s of word ``bits[:, src[e]]``.
    Equals :func:`frontier_expand_reference`."""
    n_src, c = frontier.shape
    n_words = -(-n_src // 32)
    dev = frontier.device
    shifts = torch.arange(32, dtype=torch.int64, device=dev)
    padded = torch.zeros((n_words * 32, c), dtype=torch.int64, device=dev)
    padded[:n_src] = frontier.to(torch.int64)
    bits = (padded.view(n_words, 32, c) << shifts[None, :, None]).sum(1)  # [W, C]
    words = bits[:, src.long()]                                            # [W, Ce]
    set_bits = ((words[:, None, :] >> shifts[None, :, None]) & 1).view(n_words * 32, -1)
    s_idx, e_idx = set_bits[:n_src].nonzero(as_tuple=True)
    out = torch.full((n_src * c,), NBR_INF, dtype=torch.int32, device=dev)
    out.scatter_reduce_(0, s_idx * c + dst.long()[e_idx], src[e_idx], "amin")
    return out.view(n_src, c)
