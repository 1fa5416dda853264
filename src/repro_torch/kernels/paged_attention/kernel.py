"""Launch wrapper for the CUDA paged decode attention
(``csrc/paged_attention.cu``).

Replaces the Pallas kernel
``repro/kernels/paged_attention/kernel.py::paged_attention``.  The note on
what bounds it and how it is laid out is in the CUDA source.

The wrapper reads four numbers back from the device once per call, and so
waits for the work queued before it: it refuses a ``seq_lens`` outside
``[0, pages_per_seq * page_size]`` and a page id outside ``[0, P)`` on a live
page (the kernel must never read outside the pool), and it picks the
length of a split from the live lengths.
"""

from __future__ import annotations

import torch

from .. import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 128
_MAX_GROUP = 16
_GRID_YZ = 65535
_MAX_POSITIONS = 2**30
_TILE = 64          # positions a tile, as in the kernel
_MIN_SPLIT = 256    # positions: a shorter split costs more in its partial than in its rows
_BLOCKS_PER_SM = 16  # blocks of work the splits aim at per SM: the last wave stays short


def _split_len(total: int, longest: int, hkv: int, device) -> int:
    """Positions a block walks: the live work (total positions times KV
    heads) over about sixteen blocks an SM, in whole tiles, at least
    ``_MIN_SPLIT`` and at most the longest sequence."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_block = -(-total * hkv // (_BLOCKS_PER_SM * sms))
    split = max(_MIN_SPLIT, -(-per_block // _TILE) * _TILE)
    return max(_TILE, min(split, -(-longest // _TILE) * _TILE))


def _check_values(block_table, seq_lens, num_pages: int, page_size: int):
    """(total, longest) live length; raises on a length outside the table
    or a live page id outside the pool.  One read from the device."""
    lens = seq_lens.to(torch.int64)
    pages = block_table.shape[1]
    live = torch.arange(pages, device=lens.device)[None, :] * page_size < lens[:, None]
    bad = live & ((block_table < 0) | (block_table >= num_pages))
    shortest, longest, total, n_bad = torch.stack(
        [lens.min(), lens.max(), lens.sum(), bad.sum()]).tolist()
    if shortest < 0 or longest > pages * page_size:
        raise ValueError(f"paged_attention: seq_lens must lie in [0, {pages * page_size}] "
                         f"(pages_per_seq * page_size), got [{shortest}, {longest}]")
    if n_bad:
        raise ValueError(f"paged_attention: {n_bad} live page ids outside [0, {num_pages})")
    return total, longest


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_table: torch.Tensor, seq_lens: torch.Tensor, *,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Decode attention over contiguous CUDA tensors q (B, Hq, D) and
    k_pages, v_pages (P, page_size, Hkv, D) of one dtype, f32 or bf16, with
    block_table (B, pages_per_seq) and seq_lens (B,) int32; out has q's
    shape and dtype.  Hq / Hkv in 1..16, D a multiple of 8 up to 128."""
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("paged_attention: q, k_pages, v_pages must share one dtype, "
                        "float32 or bfloat16")
    if block_table.dtype != torch.int32 or seq_lens.dtype != torch.int32:
        raise TypeError("paged_attention: block_table and seq_lens must be int32")
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape \
            or block_table.dim() != 2 or seq_lens.dim() != 1:
        raise ValueError("paged_attention: q (B, Hq, D), k_pages and v_pages (P, page_size, "
                         "Hkv, D), block_table (B, pages_per_seq), seq_lens (B,)")
    B, Hq, D = q.shape
    P, page_size, Hkv, _ = k_pages.shape
    pps = block_table.shape[1]
    if k_pages.shape[3] != D or block_table.shape[0] != B or seq_lens.shape[0] != B:
        raise ValueError("paged_attention: batch and head dim must match across the inputs")
    if Hkv < 1 or Hq % Hkv or not 1 <= Hq // Hkv <= _MAX_GROUP:
        raise ValueError(f"paged_attention: Hq {Hq} must be Hkv {Hkv} times a group of "
                         f"1..{_MAX_GROUP}")
    if D % 8 or not 0 < D <= _MAX_D:
        raise ValueError(f"paged_attention: head dim {D} must be a multiple of 8, at most {_MAX_D}")
    if min(B, P, page_size, pps) < 1 or max(B, Hkv) > _GRID_YZ or pps * page_size > _MAX_POSITIONS:
        raise ValueError(f"paged_attention: shape q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}, table {tuple(block_table.shape)} out of range")
    if block_table.device != seq_lens.device:
        raise ValueError(f"paged_attention: block_table on {block_table.device}, seq_lens on "
                         f"{seq_lens.device}")
    total, longest = _check_values(block_table, seq_lens, P, page_size)
    _build.require_cuda("paged_attention", q, k_pages, v_pages, block_table, seq_lens)
    out = torch.empty_like(q)
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages, out)):
        raise ValueError("paged_attention: q, k_pages, v_pages must start on a 16-byte boundary")
    if sm_scale is None:
        sm_scale = D ** -0.5
    g = Hq // Hkv
    split_len = _split_len(total, longest, Hkv, q.device)
    splits = max(1, -(-longest // split_len))
    part_acc = torch.empty(B, Hkv, splits, g, D, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(B, Hkv, splits, g, 2, dtype=torch.float32, device=q.device)
    code = _build.library().rt_paged_attention(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
        seq_lens.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
        B, Hkv, g, D, page_size, pps, split_len, splits, float(sm_scale), _DTYPES[q.dtype],
        _build.stream_ptr(q),
    )
    _build.check(code, "rt_paged_attention")
    paged_attention.launches += 1
    paged_attention.calls += 1
    return out


paged_attention.launches = 0
paged_attention.calls = 0
