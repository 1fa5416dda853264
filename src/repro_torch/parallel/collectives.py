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
  (``grad="sum"``: the axes hold different data, as FSDP's data axes do, or
  the sequence-parallel layout's model axis does with its token blocks) or
  just one's own block (``grad="slice"``: the axes computed the same thing,
  as the model axis does with dense weights whole across it);
* :func:`scatter` — forward a reduce-scatter, backward an all-gather (a
  tensor-parallel partial over the whole sequence summed onto each rank's
  own token block);
* :func:`reduce_forward` — forward a sum over the axes, backward the
  identity (a partial result completed, then used alike on every rank);
* :func:`reduce_backward` — forward the identity, backward a sum (a value
  alike on every rank entering a computation each rank does in part);
* :func:`split` — forward one's own block, backward an all-gather (a tensor
  alike on every rank, each rank going on with its block of it: the
  d-sharded layout's embedding and shared attention block);
* :func:`psum` — forward a sum over the axes, backward a sum (a partial
  completed, then used by each rank in its own way: the d-sharded mamba2
  block's gated norm, whose variance sums every rank's channels).

**On a description.**  Given a
:class:`~repro_torch.parallel.mesh.MeshDescription` (with the coordinate of
the device it stands for) and ``meta`` tensors, the same program runs with
each ``torch.distributed`` call replaced by one op of the ``repro_mesh``
library over the axis's size: ``all_reduce_`` (in place, as
``dist.all_reduce``) and ``all_gather`` (a ``meta`` tensor of the gathered
shape).  No process group, nothing allocated; ``launch/opcost.py`` counts
each by kind at its result's bytes, as the reference's dry run counts its
HLO collectives, so a reduce-scatter is counted as what runs: an all-reduce
of the whole tensor and a copy of one's own block.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import axis_sizes, is_description
from .spec import axis_index, axis_size, names as axis_names

# the collectives of one device of a MeshDescription, on meta tensors
_LIB = torch.library.Library("repro_mesh", "DEF")
_LIB.define("all_reduce_(Tensor(a!) t, int group_size) -> Tensor(a!)")
_LIB.define("all_gather(Tensor t, int dim, int group_size) -> Tensor")


def _meta_gathered(t, dim, group_size):
    shape = list(t.shape)
    shape[dim] *= group_size
    return t.new_empty(shape)


_LIB.impl("all_reduce_", lambda t, group_size: t, "Meta")
_LIB.impl("all_gather", _meta_gathered, "Meta")


def all_reduce(t: torch.Tensor, mesh, names) -> torch.Tensor:
    """``t`` summed over the axes: a new tensor (``t`` is left as it is).
    A floating sum in another dtype than f32 or f64 runs in f32."""
    wide = t.is_floating_point() and t.dtype not in (torch.float32, torch.float64)
    sizes = axis_sizes(mesh)
    out = t.to(torch.float32, copy=True) if wide else t.clone(
        memory_format=torch.contiguous_format)
    for a in axis_names(names):
        if sizes[a] == 1:
            continue
        if is_description(mesh):
            torch.ops.repro_mesh.all_reduce_(out, sizes[a])
        else:
            dist.all_reduce(out, group=mesh.get_group(a))
    return out.to(t.dtype) if wide else out


def _gather_one(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    n = axis_sizes(mesh)[axis]
    if n == 1:
        return t
    if not t.dim():
        t, dim = t.reshape(1), 0
    # the gathered dim first, so that each rank's block is one contiguous
    # run of the result and the collective writes it in place (no parts to
    # concatenate); the result is a view with ``dim`` moved back.  The list
    # all-gather stages the whole result in one flat buffer on the card
    # before copying it out, on NCCL and gloo alike (chip_smoke.py phase
    # 22 measures it; on gloo all_gather_into_tensor stages the same, and
    # an all-reduce of the bytes, which stages nothing, took 1.6 times as
    # long).  A description runs the same ops around its stand-in for the
    # collective, and allocates that staging buffer while the result is
    # alive, so that a count sees the copy and the staging
    src = t.movedim(dim, 0).contiguous()
    if is_description(mesh):
        out = torch.ops.repro_mesh.all_gather(src, 0, n)
        staging = torch.empty_like(out)
        del staging
        return out.movedim(0, dim)
    out = torch.empty((n * src.shape[0],) + tuple(src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    # bytes: every dtype crosses as it is, on either backend
    raw = src.reshape(-1).view(torch.uint8)
    dist.all_gather(list(out.reshape(-1).view(torch.uint8).chunk(n)), raw,
                    group=mesh.get_group(axis))
    return out.movedim(0, dim)


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


def reduce_scatter(t: torch.Tensor, mesh, names, dim: int) -> torch.Tensor:
    """``t`` summed over the axes, and this rank's block of the sum along
    ``dim``: an ``all_reduce`` of the whole of ``t`` and :func:`own_block`
    (which both backends take for tensors on the card and on the host; it
    moves twice a reduce-scatter's bytes and holds the whole sum a moment).
    A floating sum in another dtype than f32 or f64 runs in f32."""
    return own_block(all_reduce(t, mesh, names), mesh, names, dim)


def _gather_order(spec) -> list:
    """(dim, entry) of the dims a spec splits, the last dim first: the
    first dim gathered last comes out contiguous (:func:`_gather_one`)."""
    return [(dim, entry) for dim, entry in reversed(list(enumerate(spec)))
            if entry is not None]


def whole(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's block by ``spec``
    (every rank gets it; a checkpoint's save)."""
    for dim, entry in _gather_order(spec):
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
            return reduce_scatter(g, ctx.mesh, ctx.names, ctx.dim), None, None, None, None
        return own_block(g, ctx.mesh, ctx.names, ctx.dim), None, None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, names, dim):
        ctx.mesh, ctx.names, ctx.dim = mesh, names, dim
        return reduce_scatter(x, mesh, names, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.mesh, ctx.names, ctx.dim), None, None, None


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


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, names, dim):
        ctx.mesh, ctx.names, ctx.dim = mesh, names, dim
        return own_block(x, mesh, names, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g.contiguous(), ctx.mesh, ctx.names, ctx.dim), None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, names):
        ctx.mesh, ctx.names = mesh, names
        return all_reduce(x, mesh, names)

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


def scatter(x: torch.Tensor, mesh, names, dim: int) -> torch.Tensor:
    """Reduce-scatter along ``dim`` over the axes (the sum's own block);
    its backward is an all-gather."""
    if axis_size(mesh, names) == 1:
        return x
    return _Scatter.apply(x, mesh, names, dim)


def reduce_forward(x: torch.Tensor, mesh, names) -> torch.Tensor:
    """Sum over the axes forward, identity backward."""
    return _ReduceForward.apply(x, mesh, names)


def split(x: torch.Tensor, mesh, names, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over the axes; its backward
    is an all-gather."""
    if axis_size(mesh, names) == 1:
        return x
    return _Split.apply(x, mesh, names, dim)


def psum(x: torch.Tensor, mesh, names) -> torch.Tensor:
    """Sum over the axes forward and backward."""
    if axis_size(mesh, names) == 1:
        return x
    return _Psum.apply(x, mesh, names)


def reduce_backward(x: torch.Tensor, mesh, names) -> torch.Tensor:
    """Identity forward, sum over the axes backward."""
    if axis_size(mesh, names) == 1:
        return x
    return _ReduceBackward.apply(x, mesh, names)


def param_view(t: torch.Tensor, spec, mesh, *, model: str) -> torch.Tensor:
    """A parameter's block ``t``, laid out by ``spec``, as a forward on
    ``mesh`` reads it.  Each dim a spec names is gathered (backward a
    reduce-scatter), and a leaf whole across some axes has its gradient
    summed over them, with the model axis as ``model`` says:

    * ``"alike"`` — gathered whole; every model rank computes the same
      thing with it (dense weights whole for the step), so over "model" the
      backward keeps one's own block and sums nothing;
    * ``"whole"`` — gathered whole; the model ranks compute different
      tokens with it (the sequence-parallel layout), so the gradient is
      summed over "model" too;
    * ``"block"`` — a dim split over "model" stays this rank's block (a
      tensor-parallel column or row block); the other dims are gathered,
      and a leaf whole across "model" is summed over it.
    """
    if model not in ("alike", "whole", "block"):
        raise ValueError(f"unknown model view {model!r}")
    named = {a for entry in spec for a in axis_names(entry)}
    summed = tuple(a for a in axis_sizes(mesh)
                   if a not in named and (a != "model" or model != "alike"))
    if summed:
        t = reduce_backward(t, mesh, summed)
    for dim, entry in _gather_order(spec):
        only_model = axis_names(entry) == ("model",)
        if only_model and model == "block":
            continue
        t = gather(t, mesh, entry, dim, grad="slice" if only_model and model == "alike" else "sum")
    return t
