"""Launch wrapper for the CUDA frontier expansion (``csrc/frontier.cu``).

Replaces the Pallas kernel ``repro/kernels/frontier/kernel.py::frontier_expand``.
A call is two launches: pack the frontier into one bit a source row (and
fill the output with NBR_INF), then expand every edge once over the set bits
of its source column.  The note on what bounds it and how it is laid out is
in the CUDA source.
"""

from __future__ import annotations

import functools

import torch

from .. import _build

PASSES = ("pack and fill", "expand")  # one launch each, a call


def prepare(frontier: torch.Tensor, src: torch.Tensor, dst: torch.Tensor):
    """Checks the inputs of :func:`frontier_expand` and allocates its output
    and the packed frontier: (out, bits, launches), where ``launches`` holds
    one callable a pass, in the order of ``PASSES``, each one CUDA launch on
    the current stream; running them in order is the expansion."""
    _build.require_cuda("frontier_expand", frontier, src, dst)
    if frontier.dtype != torch.bool or src.dtype != torch.int32 or dst.dtype != torch.int32:
        raise TypeError("frontier_expand: frontier bool, src/dst int32")
    if frontier.dim() != 2 or src.dim() != 1 or src.shape != dst.shape:
        raise ValueError("frontier_expand: frontier [S, C], src/dst [Ce]")
    n_src, c = frontier.shape
    out = torch.empty((n_src, c), dtype=torch.int32, device=frontier.device)  # the kernel fills it
    bits = torch.empty((-(-n_src // 32), c), dtype=torch.int32, device=frontier.device)
    lib = _build.library()
    args = (frontier.view(torch.uint8).data_ptr(), n_src, c, src.data_ptr(), dst.data_ptr(),
            src.shape[0], bits.data_ptr(), out.data_ptr())
    keep = (frontier, src, dst, bits)  # alive as long as the launches are

    def launch(pass_no: int):
        code = lib.rt_frontier_expand(pass_no, *args, _build.stream_ptr(keep[0]))
        _build.check(code, "rt_frontier_expand")

    return out, bits, [functools.partial(launch, p) for p in range(len(PASSES))]


def frontier_expand(
    frontier: torch.Tensor, src: torch.Tensor, dst: torch.Tensor
) -> torch.Tensor:
    """i32[S, C] for CUDA tensors: min frontier source slot over in-edges,
    NBR_INF where none.  ``src``/``dst`` values must lie in ``[0, C)``."""
    out, _, launches = prepare(frontier, src, dst)
    if out.numel():
        for launch in launches:
            launch()
            frontier_expand.launches += 1
    frontier_expand.calls += 1
    return out


frontier_expand.launches = 0
frontier_expand.calls = 0
