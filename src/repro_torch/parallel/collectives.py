"""Collectives over the named axes of a mesh, and their autograd versions.

What the reference's ``shard_map`` bodies call (``all_gather``, ``psum``,
``pmax``, ``pmean``) as explicit ``torch.distributed`` collectives on
``mesh.get_group(axis)``.  ``names`` is an axis name or a tuple of them; a
dim split over several axes is split over their product, the first name
major, and a collective over several axes runs over each in turn (the minor
first for a gather).

Every collective here is an ``all_reduce`` or an ``all_gather`` of a list,
which both NCCL and gloo take for tensors on the card and on the host:

* a gather moves raw bytes (each tensor viewed as ``uint8``), so any dtype
  crosses bit for bit;
* a reduce-scatter is an ``all_reduce`` and a slice of one's own block, and
  a floating sum of another dtype than f32 runs in f32 and is cast back.

The process group the caller initialised picks the backend; nothing here
catches a failed collective.

The autograd versions (Megatron's pairs):

* :func:`gather` — forward an all-gather; backward a reduce-scatter
  (``grad="sum"``: the axes hold different data, as FSDP's data axes do) or
  just one's own block (``grad="slice"``: the axes computed the same thing,
  as the model axis does with dense weights whole across it);
* :func:`reduce_forward` — forward a sum over the axes, backward the
  identity (a partial result completed, then used alike on every rank);
* :func:`reduce_backward` — forward the identity, backward a sum (a value
  alike on every rank entering a computation each rank does in part).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import axis_sizes
from .spec import axis_index, axis_size, names as axis_names

def all_reduce(t: torch.Tensor, mesh, names) -> torch.Tensor:
    """``t`` summed over the axes: a new tensor (``t`` is left as it is).
    A floating sum in another dtype than f32 or f64 runs in f32."""
    wide = t.is_floating_point() and t.dtype not in (torch.float32, torch.float64)
    out = t.to(torch.float32, copy=True) if wide else t.clone(
        memory_format=torch.contiguous_format)
    for a in axis_names(names):
        if axis_sizes(mesh)[a] > 1:
            dist.all_reduce(out, group=mesh.get_group(a))
    return out.to(t.dtype) if wide else out


def _gather_one(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = axis_sizes(mesh)[axis]
    if n == 1:
        return t
    t = t.contiguous()
    # bytes: every dtype crosses as it is, on either backend
    raw = t.view(torch.uint8) if t.dim() else t.reshape(1).view(torch.uint8)
    parts = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(parts, raw, group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim if t.dim() else 0).view(t.dtype)


def all_gather(t: torch.Tensor, mesh, names, dim: int) -> torch.Tensor:
    """The blocks of every rank along the axes, concatenated along ``dim``
    in axis order (the whole tensor a spec split there)."""
    for a in reversed(axis_names(names)):
        t = _gather_one(t, mesh, a, dim)
    return t


def own_block(t: torch.Tensor, mesh, names, dim: int) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` over the axes."""
    n = axis_size(mesh, names)
    if n == 1:
        return t
    size = t.shape[dim] // n
    return t.narrow(dim, axis_index(mesh, names) * size, size).contiguous()


def whole(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's block by ``spec``
    (every rank gets it; a checkpoint's save)."""
    for dim, entry in enumerate(spec):
        if entry is not None:
            t = all_gather(t, mesh, entry, dim)
    return t


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, names, dim, grad):
        ctx.mesh, ctx.names, ctx.dim, ctx.grad = mesh, names, dim, grad
        return all_gather(x, mesh, names, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad == "sum":
            g = all_reduce(g, ctx.mesh, ctx.names)
        return own_block(g, ctx.mesh, ctx.names, ctx.dim), None, None, None, None


class _ReduceForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, names):
        return all_reduce(x, mesh, names)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, names):
        ctx.mesh, ctx.names = mesh, names
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.mesh, ctx.names), None, None


def gather(x: torch.Tensor, mesh, names, dim: int, *, grad: str = "sum") -> torch.Tensor:
    """All-gather along ``dim`` over the axes; its backward is a
    reduce-scatter (``grad="sum"``) or one's own block (``grad="slice"``)."""
    if grad not in ("sum", "slice"):
        raise ValueError(f"unknown grad {grad!r}")
    if axis_size(mesh, names) == 1:
        return x
    return _Gather.apply(x, mesh, names, dim, grad)


def reduce_forward(x: torch.Tensor, mesh, names) -> torch.Tensor:
    """Sum over the axes forward, identity backward."""
    return _ReduceForward.apply(x, mesh, names)


def reduce_backward(x: torch.Tensor, mesh, names) -> torch.Tensor:
    """Identity forward, sum over the axes backward."""
    if axis_size(mesh, names) == 1:
        return x
    return _ReduceBackward.apply(x, mesh, names)
