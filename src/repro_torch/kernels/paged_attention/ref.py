"""Plain PyTorch version of paged decode attention.

Port of ``repro/kernels/paged_attention/ref.py``.  One new token per
sequence attends over a paged KV cache addressed through a block table (the
tables ``serving.PagedKVManager`` derives from the wait-free page table).
It gathers each sequence's pages into a contiguous view (the kernel never
does), computes the scores of ``q * sm_scale`` in f32, masks positions at or
past ``seq_lens[b]`` and takes the softmax in f32; the output is cast to q's
dtype.  It runs on any device.

One difference from the reference, on purpose: a sequence of length 0 gives
0, as ``repro``'s Pallas kernel does (every page skipped, ``acc / max(l,
1e-30)``), where ``repro``'s ``paged_attention_reference`` takes the softmax
of a row that is all ``-1e30`` and returns the mean of v over the whole
table.  Table entries past a sequence's live pages are not read: they are
gathered as page 0, so a table may hold anything there.
"""

from __future__ import annotations

import torch

F32 = torch.float32
NEG_INF = -1e30


def paged_attention_reference(q, k_pages, v_pages, block_table, seq_lens, *,
                              sm_scale: float | None = None):
    """q (B, Hq, D); k_pages, v_pages (P, page_size, Hkv, D); block_table
    (B, pages_per_seq) int32 page ids; seq_lens (B,) int32 live lengths ->
    (B, Hq, D) in q's dtype."""
    B, Hq, D = q.shape
    _, page_size, Hkv, _ = k_pages.shape
    pages_per_seq = block_table.shape[1]
    if Hq % Hkv:
        raise ValueError(f"Hq {Hq} is not a multiple of Hkv {Hkv}")
    g = Hq // Hkv
    if sm_scale is None:
        sm_scale = D ** -0.5
    S = pages_per_seq * page_size
    lens = seq_lens.to(torch.int64)[:, None]
    live_page = torch.arange(pages_per_seq, device=q.device)[None, :] * page_size < lens
    table = torch.where(live_page, block_table.to(torch.int64), 0)
    k = k_pages[table].reshape(B, S, Hkv, D).to(F32)
    v = v_pages[table].reshape(B, S, Hkv, D).to(F32)

    qf = q.reshape(B, Hkv, g, D).to(F32) * sm_scale
    s = torch.einsum("bhgd,bshd->bhgs", qf, k)
    ok = (torch.arange(S, device=q.device)[None, :] < lens)[:, None, None, :]
    s = torch.where(ok, s, torch.tensor(NEG_INF, dtype=F32, device=q.device))
    # a masked position's p is exp(-1e30 - max) = 0 already, except in a row
    # that is all masked (length 0): zeroing p there gives 0, not a mean of v
    p = torch.where(ok, torch.softmax(s, dim=-1), torch.zeros((), dtype=F32, device=q.device))
    out = torch.einsum("bhgs,bshd->bhgd", p, v)
    return out.reshape(B, Hq, D).to(q.dtype)
