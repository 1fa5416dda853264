"""Specs, and a rank's block of a tensor laid out by one.

A spec is a tuple with one entry a dim, as a ``jax.sharding.PartitionSpec``
holds them: ``None`` (whole), an axis name, or a tuple of axis names (the
dim split over their product, the first name major).  A spec shorter than
its tensor leaves the remaining dims whole.  ``mesh`` is a ``DeviceMesh``
or a :class:`~repro_torch.parallel.mesh.MeshDescription` everywhere but
where a rank's coordinate is read (:func:`axis_index` and
:func:`local_shard` without ``coord``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .mesh import axis_sizes


def names(entry) -> tuple:
    """An entry of a spec as a tuple of axis names (empty for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axis_size(mesh, entry) -> int:
    """The number of ranks along the product of an entry's axes."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[n] for n in names(entry))


def spec_entry(axes):
    """A spec entry as ``PartitionSpec`` holds it: one name alone, not in a
    tuple."""
    if isinstance(axes, (tuple, list)) and len(axes) == 1:
        return axes[0]
    return axes if isinstance(axes, str) or axes is None else tuple(axes)


def _entries(spec, ndim: int) -> tuple:
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's {ndim} dims")
    return spec + (None,) * (ndim - len(spec))


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's block of a tensor of ``shape`` laid out by
    ``spec`` (each named dim divided by its axes' size); raises where a dim
    does not divide."""
    out = []
    for dim, entry in zip(shape, _entries(spec, len(shape))):
        n = axis_size(mesh, entry)
        if dim % n:
            raise ValueError(f"dim {dim} of shape {tuple(shape)} does not split over "
                             f"{names(entry)} ({n} ranks)")
        out.append(dim // n)
    return tuple(out)


def axis_index(mesh, entry, coord: Optional[Dict[str, int]] = None) -> int:
    """This rank's index along the product of an entry's axes (the first
    major), from ``coord`` ({axis: index}) or else the mesh's own
    coordinate."""
    sizes = axis_sizes(mesh)
    idx = 0
    for n in names(entry):
        i = coord[n] if coord is not None else mesh.get_local_rank(n)
        idx = idx * sizes[n] + i
    return idx


def local_shard(tensor: torch.Tensor, spec, mesh, coord: Optional[Dict[str, int]] = None):
    """The rank's block of the whole ``tensor`` laid out by ``spec``, as a
    contiguous copy.  ``coord`` ({axis: index}) names another rank's block
    (a test's oracle); by default it is the calling rank's."""
    sizes = local_shape(tensor.shape, spec, mesh)
    out = tensor
    for dim, (entry, size) in enumerate(zip(_entries(spec, tensor.dim()), sizes)):
        if entry is not None:
            out = out.narrow(dim, axis_index(mesh, entry, coord) * size, size)
    return out.clone(memory_format=torch.contiguous_format)


def token_range(mesh, seq_len: int) -> tuple:
    """(start, stop) of the rank's tokens in the sequence-parallel layout:
    the sequence split into contiguous blocks over "model", block ``m`` the
    tokens [m S / M, (m + 1) S / M).  Raises ``ValueError`` where S does not
    divide."""
    n = axis_size(mesh, "model")
    if seq_len % n:
        raise ValueError(f"the sequence-parallel layout splits the {seq_len} tokens over "
                         f"\"model\" ({n} ranks): they do not divide")
    start = axis_index(mesh, "model") * (seq_len // n)
    return start, start + seq_len // n


def dealt(total: int, n: int) -> list:
    """(start, stop) of each of ``n`` ranks' contiguous share of ``total``
    items (heads): rank ``m`` the items [⌊total·m/n⌋, ⌊total·(m+1)/n⌋), so
    the shares differ by at most one where ``n`` does not divide ``total``."""
    return [(total * m // n, total * (m + 1) // n) for m in range(n)]


def first_split_dim(shape, n: int, start: int):
    """The first dim of ``shape`` from ``start`` on that ``n`` ranks split:
    one that ``n`` divides and that is at least ``n`` long; None where no
    dim is (the decode cache's rule for a recurrent state over "model")."""
    for i in range(start, len(shape)):
        if shape[i] % n == 0 and shape[i] >= n:
            return i
    return None
