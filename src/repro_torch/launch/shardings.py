"""Sharding policy: how batches and decode caches map onto the mesh, and
which rows of the global batch a data rank holds.

Port of ``repro.launch.shardings``; specs, and a rank's block of a tensor,
are :mod:`repro_torch.parallel.spec`'s.  The data axes are the mesh's own
(:func:`~repro_torch.parallel.mesh.data_axes`: "data", or "pod" and "data"
across pods; the reference's ``logical_dp(multi_pod)``).  Rules, with the
reference's divisibility fallbacks so that every arch × shape cell has a
layout:

* batch dim -> data axes when divisible, else replicated (long_500k, B=1);
* decode KV caches: batch -> data, cache T axis -> "model" (flash-decoding
  stripes) when divisible;
* recurrent states: batch -> data, then the first of (heads, K, V)
  divisible by the model axis -> "model";
* image memory: batch -> data, token axis -> "model".

``mesh`` is a ``DeviceMesh`` or a
:class:`~repro_torch.parallel.mesh.MeshDescription`.  :func:`decode_cache`
allocates ``LM.decode_init``'s cache as one rank's blocks by
:func:`cache_pspecs` (the striped-cache decode of ``models/lm.py``).
"""

from __future__ import annotations

import torch

from ..models import LM
from ..models.lm import ring_record
from ..models.config import ArchConfig
from ..models.module import tree_map
from ..parallel.mesh import data_axes
from ..parallel.spec import axis_size, first_split_dim, local_shape, spec_entry


def _maybe(dim_size: int, axes, mesh):
    """axes if divisible else None."""
    return spec_entry(axes) if dim_size % axis_size(mesh, axes) == 0 else None


def batch_pspecs(cfg: ArchConfig, B: int, mesh):
    bspec = _maybe(B, data_axes(mesh), mesh)
    return {
        "tokens": (bspec, None) if cfg.n_codebooks == 1 else (bspec, None, None),
        "mask": (bspec, None),
        "memory": (bspec, _maybe(cfg.n_img_tokens, "model", mesh), None),
    }


def cache_pspecs(cfg: ArchConfig, cache_shapes, B: int, mesh):
    """A spec tree matching ``LM.decode_init``'s structure (its leaves give
    the shapes: tensors, on the ``meta`` device too)."""
    bs = _maybe(B, data_axes(mesh), mesh)
    n_model = axis_size(mesh, "model")

    def kv_spec(shape):
        # (L, B, Hkv, T, Dh): stripe T over model (flash-decoding)
        return (None, bs, None, _maybe(shape[3], "model", mesh), None)

    def state_spec(shape):
        # recurrent: (L, B, ...) — the first trailing dim divisible by "model"
        spec = [None, bs] + [None] * (len(shape) - 2)
        dim = first_split_dim(shape, n_model, 2)
        if dim is not None:
            spec[dim] = "model"
        return tuple(spec)

    def assign(keys, leaf):
        if keys and keys[-1] == "len":
            return ()
        if "kv" in keys or "shared_kv" in keys or "xkv" in keys:
            return kv_spec(tuple(leaf.shape))
        if "states" in keys:
            return state_spec(tuple(leaf.shape))
        return ()

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(tree[k], keys + (k,)) for k in sorted(tree)}
        return assign(keys, tree)

    return walk(cache_shapes, ())


def decode_cache(model: LM, batch: int, max_len: int, mesh, *, params=None, memory=None):
    """``model.decode_init(batch, max_len)`` on ``mesh``: each leaf zeros of
    this rank's block by :func:`cache_pspecs` (``batch`` the global batch,
    split over the data axes where it divides), on the model's device.  The
    K/V rings' T (``min(max_len, window)``) must split over "model" (a
    ``ValueError`` otherwise): the decode step on a mesh reads the rank's
    rows as its stripe of T / M, and could not tell a whole T from one.
    For a vlm given ``params`` (the rank's blocks) and ``memory`` (the
    rank's block of the image tokens, as :func:`batch_pspecs` lays them
    out), ``xkv`` is projected from them: the rank's block of the cross
    K/V, its image tokens striped over "model".  The cache records its
    rings' global T (``cache["ring"]``, ``models.lm.ring_record``), which
    the decode step on a mesh checks its stripes against."""
    cfg = model.cfg
    shapes = LM(cfg, "meta").decode_init(batch, max_len)
    specs = cache_pspecs(cfg, shapes, batch, mesh)
    n = axis_size(mesh, "model")
    for name in ("kv", "shared_kv"):
        if name in specs and n > 1 and specs[name]["k"][3] is None:
            raise ValueError(f"decode on a mesh stripes the cache's T over \"model\": "
                             f"{shapes[name]['k'].shape[3]} rows do not split over {n} ranks")
    cache = tree_map(lambda t, s: torch.zeros(local_shape(t.shape, s, mesh), dtype=t.dtype,
                                              device=model.device), shapes, specs)
    ring = ring_record(shapes, model.device)
    if ring is not None:
        cache["ring"] = ring
    if cfg.xattn_every and params is not None and memory is not None:
        if n > 1 and cfg.n_img_tokens % n:
            raise ValueError(f"the cross K/V's {cfg.n_img_tokens} image tokens do not split "
                             f"over \"model\" ({n} ranks)")
        cache["xkv"] = model.cross_kv(params, memory, mesh=mesh)
    return cache


def data_rows(global_batch: int, accum: int, n_dp: int, index: int) -> list:
    """The global batch rows that data index ``index`` of ``n_dp`` holds,
    microbatch by microbatch: microbatch ``i`` is the rows
    ``[i B / accum, (i + 1) B / accum)`` (the reference's reshape of the
    batch into ``accum`` microbatches), and each data index holds its block
    of each."""
    if global_batch % (accum * n_dp):
        raise ValueError(f"a batch of {global_batch} rows does not split into {accum} "
                         f"microbatches over {n_dp} data ranks")
    per = global_batch // (accum * n_dp)
    return [i * (global_batch // accum) + index * per + r
            for i in range(accum) for r in range(per)]
