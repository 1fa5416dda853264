"""Decoder LM assembly for the dense, ssm and hybrid families, inference only.

Port of ``repro.models.lm.LM`` for ``family`` in ``dense`` (attention
blocks), ``ssm`` (rwkv6 blocks) and ``hybrid`` (mamba2 blocks with one
shared attention block after every ``shared_attn_every`` layers, zamba2):
parameter meta and init, the prefill forward (``hidden_states`` +
``_logits``, with the recurrent states in and out) and the one-token decode
step over a KV cache and/or recurrent states.  Parameters are a nested dict
of tensors laid out as the reference's pytree, with the repeated blocks
stacked along a leading layer dim; the reference scans over that dim, the
port loops over it in Python.  Remat and sequence-parallel constraints have
no meaning for inference on one card and are not carried over; a ``run``
dict may still name them and they are ignored.

:func:`params_from_numpy` carries the reference's parameter pytree (numpy
leaves) into the port, and serves as the port's checkpoint-in;
:func:`params_to_numpy` is its inverse.

The model lives on the card unless the caller asks for another device:
``device=None`` means ``"cuda"``, and raises where no card is present.
The moe, vlm and audio families raise ``NotImplementedError`` (ROADMAP.md
queue 1).
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
    "scan_impl": "chunked",   # "chunked" | "reference" (the recurrent prefill's scan)
}

_BLOCK_KINDS = {"dense": "attn", "ssm": "rwkv6", "hybrid": "mamba2"}


def _layer(blocks, i: int):
    return tree_map(lambda a: a[i], blocks)


def _write_state(states, i: int, new) -> None:
    """Store layer ``i``'s new recurrent state into the stacked states, in
    place (the reference returns updated copies)."""
    for name, t in new.items():
        states[name][i].copy_(t)


class LM:
    """Config-driven decoder LM: meta / init / forward / decode."""

    def __init__(self, cfg: ArchConfig, device=None):
        if cfg.family not in _BLOCK_KINDS or cfg.moe is not None:
            raise NotImplementedError(
                f"LM family {cfg.family!r}: ROADMAP.md queue 1, the other LM families"
            )
        self.cfg = cfg
        self.block_kind = _BLOCK_KINDS[cfg.family]
        self.device = resolve_device(device, "LM")

    # -- parameter metadata -------------------------------------------------
    def _block_meta(self):
        if self.block_kind == "rwkv6":
            return B.rwkv6_block_meta(self.cfg)
        if self.block_kind == "mamba2":
            return B.mamba2_block_meta(self.cfg)
        return B.attn_block_meta(self.cfg)

    def meta(self):
        cfg = self.cfg
        m = {
            "embed": L.embed_meta(cfg),
            "blocks": stack_meta(self._block_meta(), cfg.n_layers),
            "ln_f": L.norm_meta(cfg),
        }
        if cfg.shared_attn_every:
            m["shared_attn"] = B.attn_block_meta(cfg)
        return m

    def init(self, generator: torch.Generator):
        """Random parameters drawn with ``generator`` (on the model's
        device) and materialised there."""
        return build_params(self.meta(), generator, self.device)

    # -- forward (prefill) ----------------------------------------------------
    def hidden_states(self, params, tokens, *, run=None, positions=None, states=None):
        """Embeds and runs the block stack.  Returns (hidden, aux_loss,
        new_states) as the reference does: the families here have no aux
        loss; ``new_states`` are the stacked recurrent states after the
        prompt (ssm/hybrid, for the prefill-to-decode handoff), None for
        dense.  ``states`` are the stacked states to start from (None: a
        fresh start)."""
        cfg = self.cfg
        run = {**DEFAULT_RUN, **(run or {})}
        x = L.embed_apply(params["embed"], cfg, tokens)
        if self.block_kind == "attn":
            if not cfg.rope:
                pos = positions if positions is not None else torch.arange(x.shape[1],
                                                                           device=x.device)
                x = x + L.sinusoid_embed(pos, cfg.d_model)[None].to(x.dtype)
            for i in range(cfg.n_layers):
                x = self._attn_block(_layer(params["blocks"], i), x, run, positions)
            new_states = None
        else:
            x, new_states = self._recurrent_stack(params, x, run, positions, states)
        x = L.norm_apply(params["ln_f"], cfg, x)
        return x, 0.0, new_states

    def _attn_block(self, p, x, run, positions):
        x, _, _ = B.attn_block_apply(
            p, self.cfg, x, positions=positions, attn_impl=run["attn_impl"],
            block_q=run["attn_block_q"], block_k=run["attn_block_k"],
        )
        return x

    def _shared_after(self, i: int) -> bool:
        """Whether the hybrid stack runs its shared attention block after
        layer ``i``: once per full group of ``every`` layers, so a tail of
        ``n_layers % every`` layers runs without it."""
        every = self.cfg.shared_attn_every
        n_head = (self.cfg.n_layers // every) * every
        return (i + 1) % every == 0 and i < n_head

    def _recurrent_stack(self, params, x, run, positions, states):
        """rwkv6 layers (ssm), or zamba2's groups of ``every`` mamba2 layers
        each followed by the shared attention block, then the mamba2 tail
        (hybrid).  Returns (x, stacked new states)."""
        cfg = self.cfg
        hybrid = self.block_kind == "mamba2"
        apply = B.mamba2_block_apply if hybrid else B.rwkv6_block_apply
        new = []
        for i in range(cfg.n_layers):
            st = None if states is None else _layer(states, i)
            x, ns = apply(_layer(params["blocks"], i), cfg, x, state=st,
                          scan_impl=run["scan_impl"])
            new.append(ns)
            if hybrid and self._shared_after(i):
                x = self._attn_block(params["shared_attn"], x, run, positions)
        return x, {name: torch.stack([ns[name] for ns in new]) for name in new[0]}

    def init_recurrent_states(self, batch: int, dtype):
        """Stacked per-layer recurrent states for ssm/hybrid stacks, zeros;
        None for dense."""
        cfg = self.cfg
        if self.block_kind == "rwkv6":
            one = B.rwkv6_state_init(cfg, batch, dtype, self.device)
        elif self.block_kind == "mamba2":
            one = B.mamba2_state_init(cfg, batch, dtype, self.device)
        else:
            return None
        return {name: torch.zeros((cfg.n_layers,) + tuple(t.shape), dtype=t.dtype,
                                  device=t.device) for name, t in one.items()}

    def _logits(self, params, x):
        return L.logits_apply(params["embed"], self.cfg, x)

    # -- decode ---------------------------------------------------------------
    def decode_init(self, batch: int, max_len: int):
        """Allocate the decode cache: the shared length, plus per-layer ring
        buffers of K and V (of capacity ``window`` for sliding-window archs)
        for dense, the stacked recurrent states for ssm, and both for hybrid,
        whose KV buffers hold one entry per occurrence of the shared block."""
        cfg = self.cfg
        dt, dev = cfg.param_dtype, self.device
        cache: Dict[str, Any] = {"len": torch.zeros((), dtype=torch.int32, device=dev)}
        kv_len = min(max_len, cfg.window) if cfg.window else max_len

        def kv(n):
            shape = (n, batch, cfg.n_kv_heads, kv_len, cfg.head_dim)
            return {"k": torch.zeros(shape, dtype=dt, device=dev),
                    "v": torch.zeros(shape, dtype=dt, device=dev)}

        if self.block_kind == "attn":
            cache["kv"] = kv(cfg.n_layers)
        else:
            cache["states"] = self.init_recurrent_states(batch, dt)
        if self.block_kind == "mamba2":
            cache["shared_kv"] = kv(cfg.n_layers // cfg.shared_attn_every)
        return cache

    def decode_step(self, params, tokens, cache, *, run=None):
        """One token per sequence; tokens (B, 1).  Returns (logits, cache').
        The new K/V rows and recurrent states are written into ``cache``'s
        tensors in place, and ``cache'`` holds those tensors with the
        advanced length; a slot's ``cache["start"]`` offset masks the KV rows
        of its predecessor."""
        cfg = self.cfg
        pos = cache["len"]
        x = L.embed_apply(params["embed"], cfg, tokens)
        if self.block_kind == "attn":
            if not cfg.rope:
                x = x + L.sinusoid_embed(pos.reshape(1), cfg.d_model)[None].to(x.dtype)
            x = self._attn_decode(params, x, cache)
        else:
            x = self._recurrent_decode(params, x, cache)
        x = L.norm_apply(params["ln_f"], cfg, x)
        return self._logits(params, x), {**cache, "len": pos + 1}

    def _attn_decode_block(self, p, x, k, v, cache):
        """One attention block's decode step against its K/V ring buffers."""
        pos = cache["len"]
        kv = {"k": k, "v": v, "len": pos, "start": cache.get("start")}
        x, _, _ = B.attn_block_apply(p, self.cfg, x, kv_cache=kv,
                                     positions=pos + torch.arange(x.shape[1], device=x.device))
        return x

    def _attn_decode(self, params, x, cache):
        for i in range(self.cfg.n_layers):
            x = self._attn_decode_block(_layer(params["blocks"], i), x, cache["kv"]["k"][i],
                                      cache["kv"]["v"][i], cache)
        return x

    def _recurrent_decode(self, params, x, cache):
        """rwkv6 steps, or the hybrid group walk mirroring
        :meth:`_recurrent_stack`: mamba2 steps, with the shared attention
        block against its per-occurrence KV cache after each full group."""
        cfg = self.cfg
        hybrid = self.block_kind == "mamba2"
        apply = B.mamba2_block_apply if hybrid else B.rwkv6_block_apply
        states = cache["states"]
        occ = 0
        for i in range(cfg.n_layers):
            x, ns = apply(_layer(params["blocks"], i), cfg, x, state=_layer(states, i))
            _write_state(states, i, ns)
            if hybrid and self._shared_after(i):
                x = self._attn_decode_block(params["shared_attn"], x, cache["shared_kv"]["k"][occ],
                                          cache["shared_kv"]["v"][occ], cache)
                occ += 1
        return x


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
