"""Decoder LM assembly for the dense family, inference only.

Port of ``repro.models.lm.LM`` for ``family == "dense"``: parameter meta
and init, the prefill forward (``hidden_states`` + ``_logits``) and the
one-token decode step over a KV cache.  Parameters are a nested dict of
tensors laid out as the reference's pytree, with the repeated blocks
stacked along a leading layer dim; the reference scans over that dim, the
port loops over it in Python.  Remat and sequence-parallel constraints have
no meaning for inference on one card and are not carried over; a ``run``
dict may still name them and they are ignored.

:func:`params_from_numpy` carries the reference's parameter pytree (numpy
leaves) into the port, and serves as the port's checkpoint-in;
:func:`params_to_numpy` is its inverse.

The model lives on the card unless the caller asks for another device:
``device=None`` means ``"cuda"``, and raises where no card is present.
Other families raise ``NotImplementedError`` (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device
from . import blocks as B
from . import layers as L
from .config import ArchConfig
from .module import build_params, stack_meta, tree_map

DEFAULT_RUN: Dict[str, Any] = {
    "attn_impl": "chunked",   # "chunked" | "kernel" | "reference"
    "attn_block_q": 512,      # chunk sizes of the plain attention
    "attn_block_k": 512,
}


def _layer(blocks, i: int):
    return tree_map(lambda a: a[i], blocks)


class LM:
    """Config-driven decoder LM: meta / init / forward / decode."""

    def __init__(self, cfg: ArchConfig, device=None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"LM family {cfg.family!r}: ROADMAP.md queue 1, the other LM families"
            )
        self.cfg = cfg
        self.device = resolve_device(device, "LM")

    # -- parameter metadata -------------------------------------------------
    def meta(self):
        cfg = self.cfg
        return {
            "embed": L.embed_meta(cfg),
            "blocks": stack_meta(B.attn_block_meta(cfg), cfg.n_layers),
            "ln_f": L.norm_meta(cfg),
        }

    def init(self, generator: torch.Generator):
        """Random parameters drawn with ``generator`` (on the model's
        device) and materialised there."""
        return build_params(self.meta(), generator, self.device)

    # -- forward (prefill) ----------------------------------------------------
    def hidden_states(self, params, tokens, *, run=None, positions=None):
        """Embeds and runs the block stack.  Returns (hidden, aux_loss,
        new_states) as the reference does; the dense family has no aux loss
        and no recurrent states."""
        cfg = self.cfg
        run = {**DEFAULT_RUN, **(run or {})}
        x = L.embed_apply(params["embed"], cfg, tokens)
        if not cfg.rope:
            pos = positions if positions is not None else torch.arange(x.shape[1],
                                                                       device=x.device)
            x = x + L.sinusoid_embed(pos, cfg.d_model)[None].to(x.dtype)
        for i in range(cfg.n_layers):
            x, _, _ = B.attn_block_apply(
                _layer(params["blocks"], i), cfg, x, positions=positions,
                attn_impl=run["attn_impl"],
                block_q=run["attn_block_q"], block_k=run["attn_block_k"],
            )
        x = L.norm_apply(params["ln_f"], cfg, x)
        return x, 0.0, None

    def _logits(self, params, x):
        return L.logits_apply(params["embed"], self.cfg, x)

    # -- decode ---------------------------------------------------------------
    def decode_init(self, batch: int, max_len: int):
        """Allocate the decode cache: per-layer ring buffers of K and V (of
        capacity ``window`` for sliding-window archs) and the shared length."""
        cfg = self.cfg
        kv_len = min(max_len, cfg.window) if cfg.window else max_len
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, kv_len, cfg.head_dim)
        dt, dev = cfg.param_dtype, self.device
        return {
            "len": torch.zeros((), dtype=torch.int32, device=dev),
            "kv": {"k": torch.zeros(shape, dtype=dt, device=dev),
                   "v": torch.zeros(shape, dtype=dt, device=dev)},
        }

    def decode_step(self, params, tokens, cache, *, run=None):
        """One token per sequence; tokens (B, 1).  Returns (logits, cache').
        The new K/V rows are written into ``cache``'s tensors in place, and
        ``cache'`` holds those tensors with the advanced length; a slot's
        ``cache["start"]`` offset masks the rows of its predecessor."""
        cfg = self.cfg
        pos = cache["len"]
        x = L.embed_apply(params["embed"], cfg, tokens)
        if not cfg.rope:
            x = x + L.sinusoid_embed(pos.reshape(1), cfg.d_model)[None].to(x.dtype)
        x, new_cache = self._attn_decode(params, x, cache)
        x = L.norm_apply(params["ln_f"], cfg, x)
        return self._logits(params, x), new_cache

    def _attn_decode(self, params, x, cache):
        cfg = self.cfg
        pos = cache["len"]
        positions = pos + torch.arange(x.shape[1], device=x.device)
        start = cache.get("start")  # (B,) slot admission offsets (serving)
        for i in range(cfg.n_layers):
            kv = {"k": cache["kv"]["k"][i], "v": cache["kv"]["v"][i], "len": pos,
                  "start": start}
            x, _, _ = B.attn_block_apply(
                _layer(params["blocks"], i), cfg, x, positions=positions, kv_cache=kv,
            )
        return x, {**cache, "len": pos + 1}


# ---------------------------------------------------------------------------
# parameters across packages
# ---------------------------------------------------------------------------

def _tensor_from_numpy(arr, meta, device) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: the given array may be read-only
    if tuple(arr.shape) != tuple(meta.shape):
        raise ValueError(f"parameter of shape {arr.shape}, expected {meta.shape}")
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bfloat16, as JAX hands it out
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    if t.dtype != meta.dtype:
        raise TypeError(f"parameter of dtype {t.dtype}, expected {meta.dtype}")
    return t.to(device)


def params_from_numpy(cfg: ArchConfig, tree, device=None):
    """The reference's parameter pytree (nested dicts of numpy arrays,
    stacked blocks) as the port's parameters on ``device``; every leaf is
    checked against the model's meta."""
    model = LM(cfg, device)
    return tree_map(lambda m, a: _tensor_from_numpy(a, m, model.device), model.meta(), tree)


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # the numpy bfloat16 type the reference's arrays use

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_numpy(params):
    """The inverse of :func:`params_from_numpy`."""
    return tree_map(_tensor_to_numpy, params)
