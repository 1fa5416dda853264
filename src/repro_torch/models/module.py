"""Minimal parameter-tree system.

Port of ``repro.models.module``.  One source of truth per layer: a *meta
tree* (nested dicts) of :class:`ParamMeta` leaves giving each parameter's
shape, dtype and init rule.  :func:`build_params` materialises it as a tree
of tensors on the device it is given, drawing from an explicit
``torch.Generator`` on that device, so a full-width model is drawn on the
card and never on the host; :func:`build_shapes` gives its stand-ins on the
``meta`` device.

``spec`` holds the reference's logical axis names a dim ("fsdp", "tp",
"dp" or None); :func:`resolve_spec` maps them to the mesh's axes and
:func:`build_pspecs` does so for a whole tree, as the reference's
``resolve_spec`` and ``build_pspecs`` do.  A resolved spec is a tuple with
one entry a dim: None, an axis name, or a tuple of names
(:mod:`repro_torch.parallel.spec`).
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch


class ParamMeta(NamedTuple):
    shape: tuple
    dtype: Any           # a torch dtype
    spec: tuple          # logical names per dim: "fsdp" | "tp" | "dp" | None
    init: str            # "normal" | "zeros" | "ones" | "embed"
    scale: float = 1.0   # multiplier on the init std


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts (keys in sorted order)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def _std(meta: ParamMeta) -> float:
    if meta.init == "embed":
        return meta.scale
    # "normal": fan-in is the second-to-last dim (the last for a vector); a
    # stacked leaf's leading layer dim does not change it
    fan_in = meta.shape[-2] if len(meta.shape) >= 2 else meta.shape[-1]
    return meta.scale / math.sqrt(max(fan_in, 1))


def _leaf_init(meta: ParamMeta, generator: torch.Generator, device) -> torch.Tensor:
    if meta.init == "zeros":
        return torch.zeros(meta.shape, dtype=meta.dtype, device=device)
    if meta.init == "ones":
        return torch.ones(meta.shape, dtype=meta.dtype, device=device)
    if meta.init not in ("embed", "normal"):
        raise ValueError(meta.init)
    std = _std(meta)
    out = torch.empty(meta.shape, dtype=meta.dtype, device=device)
    # draw in f32 one leading slice at a time, so a stacked leaf never needs
    # an f32 copy of itself
    rows = out if out.dim() >= 3 else out[None]
    for row in rows:
        row.copy_(torch.randn(row.shape, generator=generator, device=device) * std)
    return out


def build_params(meta_tree, generator: torch.Generator, device=None):
    """Materialise parameters from a meta tree with ``generator``, on
    ``device`` (default: the generator's device)."""
    device = torch.device(device) if device is not None else generator.device
    return tree_map(lambda m: _leaf_init(m, generator, device), meta_tree)


def build_shapes(meta_tree):
    """Stand-ins of the parameters on the ``meta`` device, with their shapes
    and dtypes: nothing is drawn or allocated (the reference's
    ``ShapeDtypeStruct`` tree, for counting a step without running it)."""
    return tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype, device="meta"), meta_tree)


def resolve_spec(logical, *, multi_pod: bool) -> tuple:
    """Map logical dim names to mesh axes: "fsdp" and "dp" to the data axes
    ("data", or ("pod", "data") across pods), "tp" to "model"."""
    fsdp = ("pod", "data") if multi_pod else "data"
    out = []
    for name in logical:
        if name is None:
            out.append(None)
        elif name in ("fsdp", "dp"):
            out.append(fsdp)
        elif name == "tp":
            out.append("model")
        else:
            raise ValueError(f"unknown logical axis {name}")
    return tuple(out)


def build_pspecs(meta_tree, *, multi_pod: bool):
    return tree_map(lambda m: resolve_spec(m.spec, multi_pod=multi_pod), meta_tree)


def stack_meta(meta_tree, n: int):
    """Prepend a stacked-layer dimension (the reference scans over it; the
    port loops over it)."""
    return tree_map(
        lambda m: ParamMeta((n,) + tuple(m.shape), m.dtype, (None,) + tuple(m.spec),
                            m.init, m.scale),
        meta_tree,
    )


def param_count(meta_tree) -> int:
    return sum(math.prod(m.shape) for m in tree_leaves(meta_tree))


def param_bytes(meta_tree) -> int:
    return sum(math.prod(m.shape) * m.dtype.itemsize for m in tree_leaves(meta_tree))
