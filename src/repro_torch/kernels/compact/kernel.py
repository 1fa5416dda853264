"""Launch wrappers for the CUDA compaction primitives (``csrc/compact.cu``).

Replace the Pallas kernels ``repro/kernels/compact/kernel.py::masked_compact``
and ``::probe_place``.  ``masked_compact`` is one launch (a decoupled
look-back over 4,096-lane tiles, the tail filled by reverse rank) after one
memset of its scratch; ``probe_place`` is three launches a claim round.
The notes on what bounds each and how it is laid out are in the CUDA source.
"""

from __future__ import annotations

import torch

from ...core.types import INT32_MAX
from .. import _build

_COMPACT_TILE = 4096  # lanes a block takes in compact.cu


def masked_compact(
    values: torch.Tensor, mask: torch.Tensor, *, fill: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out i32[R, N], count i32[]) for CUDA tensors: stable compaction of
    the columns of ``values`` where ``mask`` is set, tail filled.  One
    launch; every output element is written once, so nothing is pre-filled."""
    _build.require_cuda("masked_compact", values, mask)
    if values.dtype != torch.int32 or mask.dtype != torch.bool:
        raise TypeError("masked_compact: values int32, mask bool")
    if values.dim() != 2 or mask.dim() != 1 or values.shape[1] != mask.shape[0]:
        raise ValueError("masked_compact: values [R, N] and mask [N]")
    rows, n = values.shape
    if n > INT32_MAX or not -INT32_MAX - 1 <= fill <= INT32_MAX:
        raise ValueError(f"masked_compact: N {n} or fill {fill} outside int32")
    out = torch.empty((rows, n), dtype=torch.int32, device=values.device)
    if n == 0 or rows == 0:
        return out, mask.sum().to(torch.int32)
    ntiles = -(-n // _COMPACT_TILE)
    count = torch.empty((), dtype=torch.int32, device=values.device)
    scratch = torch.empty(ntiles + 1, dtype=torch.int64, device=values.device)
    code = _build.library().rt_masked_compact(
        values.data_ptr(), mask.view(torch.uint8).data_ptr(), rows, n, int(fill),
        out.data_ptr(), count.data_ptr(), scratch.data_ptr(), ntiles,
        _build.stream_ptr(values),
    )
    _build.check(code, "rt_masked_compact")
    masked_compact.launches += 1
    masked_compact.calls += 1
    return out, count


masked_compact.launches = 0
masked_compact.calls = 0


def probe_place(
    home: torch.Tensor, active: torch.Tensor, *, capacity: int, max_probes: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(slots i32[m], overflow bool[]) for CUDA tensors: claim-round
    placement into an empty ``capacity``-slot table.  The host reads two
    device counters once per round to apply the reference's stop rules."""
    _build.require_cuda("probe_place", home, active)
    if home.dtype != torch.int32 or active.dtype != torch.bool:
        raise TypeError("probe_place: home int32, active bool")
    if home.dim() != 1 or home.shape != active.shape or capacity & (capacity - 1):
        raise ValueError("probe_place: 1-d home/active and a power-of-two capacity")
    m = home.shape[0]
    dev = home.device
    slots = torch.full((m,), -1, dtype=torch.int32, device=dev)
    pending = active.to(torch.uint8)  # a copy: the rounds clear it in place
    if m == 0:
        return slots, torch.zeros((), dtype=torch.bool, device=dev)
    occ = torch.zeros(capacity, dtype=torch.uint8, device=dev)
    claim = torch.full((capacity,), INT32_MAX, dtype=torch.int32, device=dev)
    cand = torch.empty(m, dtype=torch.int32, device=dev)
    counters = torch.empty(2, dtype=torch.int32, device=dev)
    lib = _build.library()
    stream = _build.stream_ptr(home)
    rounds = 0
    while rounds < m:
        code = lib.rt_probe_place_round(
            home.data_ptr(), m, capacity, max_probes, pending.data_ptr(),
            occ.data_ptr(), claim.data_ptr(), cand.data_ptr(), slots.data_ptr(),
            counters.data_ptr(), stream,
        )
        _build.check(code, "rt_probe_place_round")
        probe_place.launches += LAUNCHES_PER_ROUND
        rounds += 1
        n_has, n_pending = counters.tolist()
        if n_has == 0 or n_pending == 0:
            break
    probe_place.calls += 1
    return slots, pending.any()


LAUNCHES_PER_ROUND = 3  # claim, settle, reset
probe_place.launches = 0
probe_place.calls = 0
