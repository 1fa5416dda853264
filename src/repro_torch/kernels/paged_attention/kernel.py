"""Launch wrapper for the CUDA paged decode attention
(``csrc/paged_attention.cu``).

Replaces the Pallas kernel
``repro/kernels/paged_attention/kernel.py::paged_attention``.  The note on
what bounds it and how it is laid out is in the CUDA source.

Before it launches, the wrapper refuses a ``seq_lens`` outside
``[0, pages_per_seq * page_size]`` and a page id outside ``[0, P)`` on a live
page (the kernel must never read outside the pool), and it picks the length
of a split from the live lengths.  Those need the tables' values, so where
the tables are read decides what a call costs:

* tables on the host (int32 CPU tensors; ``PagedKVManager.block_table``
  gives them as numpy): checked and planned on the host, then put in a
  pinned buffer that a small kernel reads onto the card in stream order.
  The call makes no read from the device and does not wait for the work
  queued before it.
* tables on the card: checked there and read back once (four numbers), so
  the call waits for the work queued before it.

Either way a refusal is raised before anything is launched.
"""

from __future__ import annotations

import numpy as np
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


def _table_stats_device(block_table, seq_lens, num_pages: int, page_size: int):
    """(shortest, longest, total, live page ids outside the pool) of tables
    on any device, by torch ops and one read of four numbers."""
    lens = seq_lens.to(torch.int64)
    pages = block_table.shape[1]
    live = torch.arange(pages, device=lens.device)[None, :] * page_size < lens[:, None]
    bad = live & ((block_table < 0) | (block_table >= num_pages))
    return tuple(torch.stack([lens.min(), lens.max(), lens.sum(), bad.sum()]).tolist())


def _table_stats_host(block_table, seq_lens, num_pages: int, page_size: int):
    """The same four numbers of host tables, in numpy (no torch dispatch:
    the host's time is part of each call)."""
    lens = seq_lens.numpy()
    longest = int(lens.max())
    stats = int(lens.min()), longest, int(lens.sum(dtype=np.int64))
    # the columns a live page can reach; a negative id is a huge uint32, so
    # one comparison catches both ends of the pool
    cols = min(block_table.shape[1], max(0, -(-longest // page_size)))
    ids = block_table.numpy()[:, :cols].view(np.uint32)
    if cols == 0 or ids.max() < num_pages:  # every id in reach lies in the pool
        return (*stats, 0)
    live = np.arange(cols, dtype=np.int64) * page_size < lens[:, None]
    return (*stats, int(np.count_nonzero((ids >= num_pages) & live)))


def _check_values(block_table, seq_lens, num_pages: int, page_size: int):
    """(total, longest) live length; raises on a length outside the table
    or a live page id outside the pool.  Host tables are checked on the
    host; tables on the card with one read from it."""
    stats = _table_stats_device if block_table.is_cuda else _table_stats_host
    shortest, longest, total, n_bad = stats(block_table, seq_lens, num_pages, page_size)
    pages = block_table.shape[1]
    if shortest < 0 or longest > pages * page_size:
        raise ValueError(f"paged_attention: seq_lens must lie in [0, {pages * page_size}] "
                         f"(pages_per_seq * page_size), got [{shortest}, {longest}]")
    if n_bad:
        raise ValueError(f"paged_attention: {n_bad} live page ids outside [0, {num_pages})")
    return total, longest


_STAGING: dict = {}  # device -> [pinned int32 buffer, event after its last read]


def _upload(block_table, seq_lens, device):
    """Host tables on ``device`` without blocking: copied into a pinned
    buffer that no launch still reads, then read by the small kernel
    ``rt_paged_stage_tables`` in stream order (a copy engine's copy, queued
    behind running work, started late: the note in the CUDA source).  The
    buffers are kept per device and reused once the event after their last
    read has passed; a new one is page-locked only when every other is still
    to be read, so a loop that queues k calls ahead holds about k."""
    n, m = block_table.numel(), block_table.numel() + seq_lens.numel()
    words = -(-m // 4) * 4  # whole 16-byte vectors
    ring = _STAGING.setdefault(device, [])
    slot = next((s for s in ring if s[0].numel() >= words and s[1].query()), None)
    if slot is None:
        slot = [torch.empty(max(words, 1 << 12), dtype=torch.int32, pin_memory=True),
                torch.cuda.Event()]
        ring.append(slot)
    flat = slot[0].numpy()
    flat[:n] = block_table.numpy().reshape(-1)
    flat[n:m] = seq_lens.numpy()
    dev = torch.empty(words, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device)
    _build.check(_build.library().rt_paged_stage_tables(
        slot[0].data_ptr(), dev.data_ptr(), 4 * words, stream.cuda_stream),
        "rt_paged_stage_tables")
    slot[1].record(stream)
    return dev[:n].view(block_table.shape), dev[n:m]


def prepare(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
            block_table: torch.Tensor, seq_lens: torch.Tensor, *,
            sm_scale: float | None = None):
    """Everything a call does before its launch: the checks (a refusal
    raises here, before anything is launched), the split plan, the upload of
    host tables, and the output and workspace.  Returns (out, launch), where
    ``launch()`` runs the two kernels on the current stream, fills ``out``
    and adds one to ``paged_attention.launches`` (``chip_smoke.py`` times it
    alone)."""
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
    on_card = block_table.is_cuda
    _build.require_cuda("paged_attention", q, k_pages, v_pages,
                        *((block_table, seq_lens) if on_card else ()))
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError("paged_attention: q, k_pages, v_pages must start on a 16-byte boundary")
    if not on_card:
        block_table, seq_lens = _upload(block_table, seq_lens, q.device)
    out = torch.empty_like(q)
    if sm_scale is None:
        sm_scale = D ** -0.5
    g = Hq // Hkv
    split_len = _split_len(total, longest, Hkv, q.device)
    splits = max(1, -(-longest // split_len))
    part_acc = torch.empty(B, Hkv, splits, g, D, dtype=torch.float32, device=q.device)
    part_ml = torch.empty(B, Hkv, splits, g, 2, dtype=torch.float32, device=q.device)
    lib = _build.library()

    def launch():  # the tensors stay alive as long as the launch does
        code = lib.rt_paged_attention(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_table.data_ptr(),
            seq_lens.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
            B, Hkv, g, D, page_size, pps, split_len, splits, float(sm_scale), _DTYPES[q.dtype],
            _build.stream_ptr(q),
        )
        _build.check(code, "rt_paged_attention")
        paged_attention.launches += 1

    return out, launch


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                    block_table: torch.Tensor, seq_lens: torch.Tensor, *,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Decode attention over contiguous CUDA tensors q (B, Hq, D) and
    k_pages, v_pages (P, page_size, Hkv, D) of one dtype, f32 or bf16, with
    block_table (B, pages_per_seq) and seq_lens (B,) int32, both on the host
    or both on q's card; out has q's shape and dtype.  Hq / Hkv in 1..16, D a
    multiple of 8 up to 128."""
    out, launch = prepare(q, k_pages, v_pages, block_table, seq_lens, sm_scale=sm_scale)
    launch()
    paged_attention.calls += 1
    return out


paged_attention.launches = 0
paged_attention.calls = 0
