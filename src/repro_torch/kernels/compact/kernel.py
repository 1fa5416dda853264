"""Launch wrappers for the CUDA compaction primitives (``csrc/compact.cu``).

Replace the Pallas kernels ``repro/kernels/compact/kernel.py::masked_compact``
and ``::probe_place``.  ``masked_compact`` is one launch (a decoupled
look-back over 4,096-lane tiles, the tail filled by reverse rank) after one
memset of its scratch; ``probe_place`` is one cooperative launch that runs
every claim round, with grid barriers between its phases, after one memset
of its control words.  The notes on what bounds each and how it is laid out
are in the CUDA source.
"""

from __future__ import annotations

import torch

from ...core.types import INT32_MAX
from .. import _build

_COMPACT_TILE = 4096  # lanes a block takes in compact.cu
_PLACE_CTL_BYTES = 4096  # probe_place's control words (compact.cu's kCtlBytes)


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


def prepare_place(
    home: torch.Tensor, active: torch.Tensor, *, capacity: int, max_probes: int
):
    """Checks the inputs of :func:`probe_place` and allocates its outputs
    and scratch: (slots, overflow, launch), where ``launch(max_rounds)`` is
    one cooperative launch on the current stream that runs at most
    ``max_rounds`` claim rounds; ``launch(m)`` is the placement, with the
    reference's stop rules.  Each launch adds its rounds to
    ``probe_place.rounds``."""
    _build.require_cuda("probe_place", home, active)
    if home.dtype != torch.int32 or active.dtype != torch.bool:
        raise TypeError("probe_place: home int32, active bool")
    if home.dim() != 1 or home.shape != active.shape or capacity < 1 \
            or capacity & (capacity - 1):
        raise ValueError("probe_place: 1-d home/active and a power-of-two capacity")
    m = home.shape[0]
    if capacity + 4 * m > INT32_MAX:
        raise ValueError(f"probe_place: {m} lanes into {capacity} slots out of range")
    dev = home.device
    slots = torch.empty((m,), dtype=torch.int32, device=dev)  # the kernel writes every lane
    overflow = torch.empty((), dtype=torch.bool, device=dev)  # the kernel writes it
    # claim words (the kernel fills them), two candidate lists, two worklists
    ints = torch.empty(capacity + 4 * m, dtype=torch.int32, device=dev)
    ctl = torch.empty(_PLACE_CTL_BYTES // 8, dtype=torch.int64, device=dev)  # zeroed by each launch
    if probe_place.rounds is None or probe_place.rounds.device != dev:
        probe_place.rounds = torch.zeros((), dtype=torch.int32, device=dev)
    rounds = probe_place.rounds
    lib = _build.library()
    keep = (home, active, ints, ctl)  # alive as long as the launch is

    def launch(max_rounds: int):
        code = lib.rt_probe_place(
            home.data_ptr(), active.view(torch.uint8).data_ptr(), m, capacity, max_probes,
            max_rounds, ints.data_ptr(), ctl.data_ptr(), slots.data_ptr(),
            overflow.data_ptr(), rounds.data_ptr(), _build.stream_ptr(keep[0]),
        )
        _build.check(code, "rt_probe_place")

    return slots, overflow, launch


def probe_place(
    home: torch.Tensor, active: torch.Tensor, *, capacity: int, max_probes: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(slots i32[m], overflow bool[]) for CUDA tensors: claim-round
    placement into an empty ``capacity``-slot table.  One launch a call,
    with no read to the host: the kernel applies the reference's stop
    rules itself, writes the overflow flag and adds its claim rounds to the
    device counter ``probe_place.rounds``."""
    slots, overflow, launch = prepare_place(home, active, capacity=capacity,
                                            max_probes=max_probes)
    m = home.shape[0]
    if m:
        launch(m)
        probe_place.launches += 1
    else:
        overflow.zero_()
    probe_place.calls += 1
    return slots, overflow


probe_place.launches = 0
probe_place.calls = 0
probe_place.rounds = None  # int32 on the card: claim rounds over every call so far
