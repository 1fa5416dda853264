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
:class:`~repro_torch.parallel.mesh.MeshDescription`.
"""

from __future__ import annotations

from ..models.config import ArchConfig
from ..parallel.mesh import data_axes
from ..parallel.spec import axis_size, spec_entry


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
        for i in range(2, len(shape)):
            if shape[i] % n_model == 0 and shape[i] >= n_model:
                spec[i] = "model"
                break
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
