"""Decoder LM assembly for every family: prefill, decode and the training
loss.

Port of ``repro.models.lm.LM``: ``family`` in ``dense``, ``moe`` (the MoE
FFN in every attention block: mixtral, granite), ``vlm`` (llama-3.2-vision:
groups of ``xattn_every`` attention layers, each followed by a gated
cross-attention block to image tokens) and ``audio`` (musicgen: sinusoid
positions and summed multi-codebook embeddings, per-codebook logits) run
attention blocks; ``ssm`` rwkv6 blocks; ``hybrid`` mamba2 blocks with one
shared attention block after every ``shared_attn_every`` layers (zamba2).
It holds the parameter meta and init, the prefill forward (``hidden_states``
+ ``_logits``, with the recurrent states in and out, and the MoE blocks'
summed balancing loss), the training loss (``loss``: the chunked
cross-entropy of :func:`_xent_chunked` plus 0.01 times the balancing loss)
and the one-token decode step over a KV cache, the vlm's precomputed cross
K/V and/or recurrent states.  Parameters are a nested dict of tensors laid
out as the reference's pytree, with the repeated blocks stacked along a
leading layer dim; the reference scans over that dim, the port unbinds it
once and loops over the layers in Python (one unbind, so a layer's gradient
lands in the stacked leaf through one stack, not a full-size zero tensor a
layer).

``run["remat"]`` checkpoints as the reference's ``jax.checkpoint`` does,
while grad mode is on: each layer of an attention or rwkv6 stack; the vlm's
groups with each of their layers nested inside; the hybrid's groups (its
mamba2 layers and the shared block) and each layer of its mamba2 tail
(``torch.utils.checkpoint``, non-reentrant).

**On a mesh** (``run["mesh"]``, a ``DeviceMesh`` over ("data", "model") or
("pod", "data", "model"), whose data axes are every axis but "model", or a
``MeshDescription`` standing for one device, with ``meta`` tensors, for the
dry run): ``params`` are this rank's blocks, each laid out by its spec
(:meth:`LM.pspecs`), and ``tokens`` this rank's rows.  Four layouts (:meth:`LM.layout` names the
prefill's and the loss's):

* **Sequence parallel** (``run["sp"]``, on by default on a mesh, as the
  reference's ``build_run``; the attention stacks: dense, moe, audio, vlm;
  prefill and loss).  The rank at model index m of M keeps the tokens
  [m S / M, (m + 1) S / M) of its rows from the embedding on (the
  reference's ``sp_spec``); S % M != 0 raises ``ValueError``.  RoPE and the
  sinusoid use those tokens' absolute positions.  Each layer gathers its
  own weights inside its checkpointed function
  (``blocks.sp_block_view``), so the backward gathers them again and a rank
  holds its blocks, one layer's gathered weights and checkpoints of S / M
  tokens: the attention's weights whole (gradients summed over every
  axis), K and V all-gathered along S and the rank's q block attending
  over them at its ``q_offset``; the dense FFN tensor parallel over its
  "model" blocks on the tokens gathered along S, its partial sum
  reduce-scattered back; the MoE's ``moe_apply_shardmap`` on the gathered
  sequence with its sum over "model" a reduce-scatter; the vlm's image
  memory gathered over "model" once.  The embedding, ``ln_f`` and the head
  are gathered where used (the loss's head once for its forward and once
  for its backward: ``_GatheredXent``).
  :meth:`hidden_states` returns the rank's token block, :meth:`prefill`
  the last token's logits on every rank.
* **d-sharded** (``run["sp"]``; the recurrent stacks: ssm and hybrid;
  prefill and loss; the reference's ``P(dp, None, "model")`` residual).
  Between layers the rank at model index m holds the d columns
  [m d / M, (m + 1) d / M) of its rows' residual, (B / D, S, d / M): the
  embedding, gathered where it is used and alike on every model rank, is
  split to that block (backward an all-gather), and each layer's
  checkpoint stores only that block.  Each layer gathers its own weights
  inside its checkpoint and deals its H heads over "model" in contiguous
  ranges [⌊H m / M⌋, ⌊H (m + 1) / M⌋) (rwkv6-3b's 40 over 16: 2, 3, 2, 3,
  ...): the normed input gathered whole along d (backward a
  reduce-scatter), the projections onto the rank's heads' channels, the
  scan over its heads, and the output's partial reduce-scattered onto its d
  block (``blocks``' module docstring).  No leaf of such a layer is read
  alike: a leaf whose "model" block is the rank's channels stays that
  block, every other is gathered whole with its gradient summed over
  "model" and sliced.  The hybrid's shared attention block runs on the
  residual gathered whole along d (backward one's own block), its weights
  whole and alike on every model rank, and the rank keeps its d block of
  its output (backward an all-gather).  The final hidden is gathered along d
  before ``ln_f`` (backward one's own block); ``ln_f`` and the head, and so
  the loss, are alike on every model rank, its count and sum over the data
  axes only.  :meth:`hidden_states` returns the hidden of the rank's rows
  whole, :meth:`prefill` the last token's logits; the new states leave
  whole on every model rank (each layer's head blocks gathered at its end,
  padded to ⌈H / M⌉ heads for the all-gather and trimmed), so the decode
  handoff is as on one device.
* **Gathered whole** (prefill and loss with ``sp`` off): :meth:`LM.mesh_params`
  gathers the dense weights whole for the call (their backward a
  reduce-scatter over the data axes and one's own block over "model", whose
  ranks compute them alike), the MoE experts left as blocks for
  ``moe_apply_shardmap``.
* **Striped cache** (every decode step on a mesh).  The cache is the
  rank's blocks by ``launch.shardings.cache_pspecs``
  (``shardings.decode_cache`` allocates them): its rows, the K/V rings'
  (``kv``, ``shared_kv``, ``xkv``) T striped over "model" (the rank at model
  index m holds the global slots [m T / M, (m + 1) T / M)), each recurrent
  state on its first trailing dim that "model" splits, ``len`` whole.  The
  hidden (B / D, 1, d) stays alike on every model rank, as the reference's
  ``decode_pin_replicated`` keeps it.  Each layer gathers its own weights
  just before it runs (``blocks.sp_block_view``; one layer's at a time):
  the attention's weights, norms and gates whole, so every model rank
  computes q, k and v alike; the dense FFN on its "model" column and row
  blocks, its partial summed over "model" in f32; an MoE FFN through
  ``moe_apply_shardmap`` (``run["decode_moe_shardmap"]``).  Only the rank
  whose stripe holds slot ``len % T`` writes the new K/V row; each rank
  attends over its stripe (masks on the global slot), and the partial
  softmaxes are merged over "model" in rank order
  (``layers._striped_attention``), so every model rank ends the step with
  the same bits.  The vlm's cross block merges the same way over its
  striped ``xkv``, the hybrid's shared block over its striped
  ``shared_kv``.  A recurrent layer (rwkv6, mamba2) gathers its weights
  and its state whole over "model", steps as on one device and keeps its
  own block of the new state: a few MB a layer (rwkv6-3b's ``h`` at 8 rows
  is 5.2 MB in f32, zamba2-1.2b's 8.4 MB); the head- or d-split step is
  later work.  The embedding, ``ln_f`` and the head are gathered where they
  are used.

An MoE model runs its FFN as ``moe_apply_shardmap`` where the reference's
``sp`` (prefill and loss) or ``decode_moe_shardmap`` (decode) picks it;
without a mesh those raise ``ValueError``, and so does an MoE model on a
mesh without them (the global dispatch would need every rank's tokens).
The loss is the global batch's on every rank: each rank's cross-entropy
sum over its tokens over the token count summed over the data axes (and
"model" in the sequence-parallel layout, whose model ranks hold other
tokens), summed over the same axes in the
forward (the identity backward: each rank's gradient is its own share),
plus the data-mean balancing loss.  ``run["attn_seq_shard"]`` (the
reference's pins of its sequence-parallel attention) is taken and changes
nothing: the layout above is that one.

:func:`params_from_numpy` carries the reference's parameter pytree (numpy
leaves) into the port, and serves as the port's checkpoint-in;
:func:`params_to_numpy` is its inverse.

The model lives on the card unless the caller asks for another device:
``device=None`` means ``"cuda"``, and raises where no card is present.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device
from ..kernels._grad import checkpointed
from ..parallel import collectives as C
from ..parallel.mesh import axis_sizes, data_axes, is_multi_pod
from ..parallel.spec import axis_size, first_split_dim, token_range
from . import blocks as B
from . import layers as L
from .config import ArchConfig
from .module import build_params, build_pspecs, build_shapes, stack_meta, tree_leaves, tree_map

DEFAULT_RUN: Dict[str, Any] = {
    "attn_impl": "chunked",   # "chunked" | "kernel" | "reference"
    "attn_block_q": 512,      # chunk sizes of the plain attention
    "attn_block_k": 512,
    "scan_impl": "chunked",   # "chunked" | "reference" (the recurrent prefill's scan)
    "remat": True,            # per-layer activation checkpointing under autograd
    "loss_chunk": 512,        # sequence chunk of the cross-entropy
}

_MOE_LEAVES = ("router", "wi", "wg", "wo")

_BLOCK_KINDS = {"dense": "attn", "moe": "attn", "audio": "attn", "vlm": "attn",
                "ssm": "rwkv6", "hybrid": "mamba2"}


def _layer(blocks, i: int):
    return tree_map(lambda a: a[i], blocks)


def _mesh_of(place):
    """The mesh of a layout (:class:`~repro_torch.models.layers.SeqParallel`
    or :class:`~repro_torch.models.layers.DSharded`); None outside one."""
    return None if place is None else place.mesh


def _view_of(place) -> str:
    """How the embedding, ``ln_f`` and the head are read in a layout
    (``collectives.param_view``'s ``model``): alike on every model rank in
    the d-sharded one, whose model ranks hold the same tokens there; summed
    over "model" in the sequence-parallel one."""
    return "alike" if isinstance(place, L.DSharded) else "whole"


def ring_record(cache, device):
    """The record a decode cache on a mesh carries of its K/V rings'
    global T (``cache["ring"]``), for ``cache`` the whole cache (its leaves'
    shapes, ``LM.decode_init``'s): a tensor of no elements and shape (0,
    T), which adds no bytes and keeps its shape on the ``meta`` device.
    None for a cache without K/V rings."""
    for name in ("kv", "shared_kv"):
        if name in cache:
            return torch.empty((0, cache[name]["k"].shape[3]), dtype=torch.int8, device=device)
    return None


def _striped(mesh):
    """The striped-cache decode's layout on ``mesh``; None without one."""
    return None if mesh is None else L.StripedCache(mesh)


def _unstack(blocks, n: int) -> list:
    """The first ``n`` layers of a stacked parameter tree, one dict each
    (one ``unbind`` a leaf)."""
    cols = tree_map(lambda a: a.unbind(0), blocks)
    return [tree_map(lambda parts: parts[i], cols) for i in range(n)]


def _remat(run, fn, *args):
    """``fn(*args)``, checkpointed while grad mode is on when ``run`` asks
    for remat."""
    return checkpointed(fn, *args) if run["remat"] else fn(*args)


def _write_state(states, i: int, new) -> None:
    """Store layer ``i``'s new recurrent state into the stacked states, in
    place (the reference returns updated copies)."""
    for name, t in new.items():
        states[name][i].copy_(t)


class LM:
    """Config-driven decoder LM: meta / init / forward / decode."""

    def __init__(self, cfg: ArchConfig, device=None):
        if cfg.family not in _BLOCK_KINDS:
            raise ValueError(f"unknown LM family {cfg.family!r}")
        self.cfg = cfg
        self.block_kind = _BLOCK_KINDS[cfg.family]
        self.device = resolve_device(device, "LM")

    # -- parameter metadata -------------------------------------------------
    def _block_meta(self):
        if self.block_kind == "rwkv6":
            return B.rwkv6_block_meta(self.cfg)
        if self.block_kind == "mamba2":
            return B.mamba2_block_meta(self.cfg)
        return B.attn_block_meta(self.cfg, moe=self.cfg.moe is not None)

    def meta(self):
        cfg = self.cfg
        m = {
            "embed": L.embed_meta(cfg),
            "blocks": stack_meta(self._block_meta(), cfg.n_layers),
            "ln_f": L.norm_meta(cfg),
        }
        if cfg.shared_attn_every:
            m["shared_attn"] = B.attn_block_meta(cfg)
        if cfg.xattn_every:
            m["xattn"] = stack_meta(B.xattn_block_meta(cfg), cfg.n_layers // cfg.xattn_every)
        return m

    def init(self, generator: torch.Generator):
        """Random parameters drawn with ``generator`` (on the model's
        device) and materialised there."""
        return build_params(self.meta(), generator, self.device)

    def shapes(self):
        """The parameters' stand-ins on the ``meta`` device (shapes and
        dtypes; nothing allocated)."""
        return build_shapes(self.meta())

    def pspecs(self, *, multi_pod: bool):
        """Each parameter's spec on the mesh (``module.build_pspecs``)."""
        return build_pspecs(self.meta(), multi_pod=multi_pod)

    # -- on a mesh --------------------------------------------------------------
    def _check_engine(self, run, key: str) -> bool:
        """Whether the MoE FFN runs as ``moe_apply_shardmap`` (``run[key]``
        on an MoE model); raises where that and the mesh disagree."""
        shard = self.cfg.moe is not None and bool(run.get(key))
        on_mesh = run.get("mesh") is not None
        if shard and not on_mesh:
            raise ValueError(f"run[{key!r}] picks moe_apply_shardmap, which needs a mesh: "
                             "pass run['mesh']")
        if on_mesh and self.cfg.moe is not None and not shard:
            raise ValueError(f"an MoE model on a mesh runs moe_apply_shardmap: set "
                             f"run[{key!r}] (the global dispatch needs every rank's tokens)")
        return shard

    def layout(self, run):
        """The layout a prefill or a loss runs in on ``run["mesh"]`` (the
        module docstring): ``"sequence-parallel"`` (an attention stack with
        ``run["sp"]``), ``"d-sharded"`` (a recurrent stack with
        ``run["sp"]``), ``"gathered-whole"`` (``sp`` off); None without a
        mesh."""
        if run.get("mesh") is None:
            return None
        if not run.get("sp"):
            return "gathered-whole"
        return "sequence-parallel" if self.block_kind == "attn" else "d-sharded"

    def _placement(self, run, seq_len: int):
        """This rank's place in its layout: a
        :class:`~repro_torch.models.layers.SeqParallel` (raises
        ``ValueError`` where the ``seq_len`` tokens do not divide over
        "model"), a :class:`~repro_torch.models.layers.DSharded`, or None
        (no mesh, or gathered whole)."""
        layout = self.layout(run)
        if layout == "sequence-parallel":
            return L.SeqParallel(run["mesh"], token_range(run["mesh"], seq_len)[0])
        if layout == "d-sharded":
            return L.DSharded(run["mesh"])
        return None

    def mesh_params(self, params, run):
        """The parameters as the forward reads them on ``run["mesh"]``
        (``params`` unchanged without one).  In the sequence-parallel and
        d-sharded layouts they stay the rank's blocks: each layer gathers
        its own inside its checkpointed function, the embedding, ``ln_f``
        and the head are gathered where used (see the module docstring).
        Otherwise :meth:`_gathered`."""
        if self.layout(run) in (None, "sequence-parallel", "d-sharded"):
            return params
        return self._gathered(params, run["mesh"])

    def _gathered(self, params, mesh):
        """Every leaf gathered whole along its spec's dims (over the data
        axes: backward a reduce-scatter; over "model": backward one's own
        block, since the model ranks compute alike), a leaf whole across a
        data axis summed over it in the backward; the MoE experts' leaves
        stay blocks, which ``moe_apply_shardmap`` gathers over the data axes
        itself."""
        specs = self.pspecs(multi_pod=is_multi_pod(mesh))

        def walk(tree, spec, keys):
            if isinstance(tree, dict):
                return {k: walk(tree[k], spec[k], keys + (k,)) for k in sorted(tree)}
            if self.cfg.moe is not None and keys[:2] == ("blocks", "ffn") \
                    and keys[-1] in _MOE_LEAVES:
                return tree
            return C.param_view(tree, spec, mesh, model="alike")

        return walk(params, specs, ())

    def _whole(self, params, name: str, mesh, only=None, model: str = "whole"):
        """``params[name]`` (the embedding or ``ln_f``) gathered whole over
        ``mesh`` where it is used (the sequence-parallel and d-sharded
        layouts and the striped-cache decode), its gradient summed over the
        data axes and, as ``model`` says (``collectives.param_view``), over
        "model" (of the embedding, only the leaves ``only`` names: the table
        for a lookup, the head for the logits); as it is without a mesh."""
        if mesh is None:
            return params[name]
        specs = self.pspecs(multi_pod=is_multi_pod(mesh))[name]
        return {k: tree_map(lambda t, s: C.param_view(t, s, mesh, model=model),
                            params[name][k], specs[k]) if only is None or k in only
                else params[name][k] for k in sorted(params[name])}

    def _head_leaves(self):
        """The embedding's leaves the logits read."""
        return ("tok",) if self.cfg.tie_embeddings else ("head",)

    def _sp_memory(self, memory, mesh):
        """The vlm's image memory whole: this rank's block (batch rows, and
        the token axis over "model" where it divides, as
        ``launch.shardings.batch_pspecs`` lays it out) gathered over "model"
        (backward a reduce-scatter: each model rank's queries read it)."""
        n = axis_size(mesh, "model")
        if memory is None or n == 1 or self.cfg.n_img_tokens % n:
            return memory
        if memory.shape[1] * n != self.cfg.n_img_tokens:
            raise ValueError(f"image memory of {memory.shape[1]} tokens: the rank's block of "
                             f"{self.cfg.n_img_tokens} over \"model\" ({n} ranks) expected")
        return C.gather(memory, mesh, "model", 1)

    # -- forward (prefill) ----------------------------------------------------
    def hidden_states(self, params, tokens, *, memory=None, run=None, positions=None,
                      states=None):
        """Embeds and runs the block stack.  Returns (hidden, aux_loss,
        new_states) as the reference does: ``aux_loss`` is the sum of the
        MoE blocks' balancing losses (0.0 without MoE); ``new_states`` are
        the stacked recurrent states after the prompt (ssm/hybrid, for the
        prefill-to-decode handoff), None for attention stacks.  ``states``
        are the stacked states to start from (None: a fresh start);
        ``memory`` (B, M, d) the vlm's image tokens."""
        run = {**DEFAULT_RUN, **(run or {})}
        shard = self._check_engine(run, "sp")
        place = self._placement(run, tokens.shape[1])
        return self._forward(self.mesh_params(params, run), tokens, memory, run, positions,
                             states, shard, place)

    def prefill(self, params, tokens, *, memory=None, run=None, states=None):
        """The prefill step's forward: :meth:`hidden_states` and the last
        token's logits, both from one view of the parameters on a mesh (in
        the sequence-parallel layout the last token's hidden state is
        gathered from the last model rank).  Returns (logits (B, 1, Vp), or
        (B, 1, n_codebooks, Vp), aux, new_states)."""
        run = {**DEFAULT_RUN, **(run or {})}
        shard = self._check_engine(run, "sp")
        place = self._placement(run, tokens.shape[1])
        params = self.mesh_params(params, run)
        hid, aux, new_states = self._forward(params, tokens, memory, run, None, states, shard,
                                             place)
        last = hid[:, -1:]
        if isinstance(place, L.SeqParallel):
            last = C.all_gather(last, place.mesh, "model", 1)[:, -1:]
        head = {"embed": self._whole(params, "embed", _mesh_of(place), self._head_leaves(),
                                     _view_of(place))}
        return self._logits(head, last), aux, new_states

    def _forward(self, params, tokens, memory, run, positions, states, shard, place=None,
                 keep_states=True):
        """:meth:`hidden_states` on the parameters' view of
        :meth:`mesh_params`; in a :class:`~repro_torch.models.layers.SeqParallel`
        ``place``, on the rank's token block; in a
        :class:`~repro_torch.models.layers.DSharded` one, the residual the
        rank's d block between the embedding and ``ln_f``.  Without
        ``keep_states`` (the loss) no layer's new state is kept."""
        cfg = self.cfg
        sp = place if isinstance(place, L.SeqParallel) else None
        mesh, view = _mesh_of(place), _view_of(place)
        if sp is not None:
            stop = sp.start + tokens.shape[1] // axis_size(sp.mesh, "model")
            tokens = tokens[:, sp.start:stop]
            positions = (torch.arange(sp.start, stop, device=tokens.device) if positions is None
                         else positions[..., sp.start:stop])
            memory = self._sp_memory(memory, sp.mesh)
        x = L.embed_apply(self._whole(params, "embed", mesh, ("tok",), view), cfg, tokens)
        if self.block_kind == "attn":
            if not cfg.rope:
                pos = positions if positions is not None else torch.arange(x.shape[1],
                                                                           device=x.device)
                x = x + L.sinusoid_embed(pos, cfg.d_model)[None].to(x.dtype)
            x, aux = self._attn_stack(params, x, memory, run, positions, shard, sp)
            new_states = None
        else:
            if place is not None:  # d-sharded: the rank's d block from here on
                x = C.split(x, mesh, "model", 2)
            x, new_states = self._recurrent_stack(params, x, run, positions, states, place,
                                                  keep_states)
            if place is not None:  # alike on every model rank from here on
                x = C.gather(x, mesh, "model", 2, grad="slice")
            aux = 0.0
        x = L.norm_apply(self._whole(params, "ln_f", mesh, model=view), cfg, x)
        return x, aux, new_states

    def _attn_block(self, p, x, run, positions, moe=False, shard=False, sp=None):
        """One attention block of the prefill; returns (x', aux)."""
        x, _, aux = B.attn_block_apply(
            p, self.cfg, x, moe=moe, positions=positions, attn_impl=run["attn_impl"],
            shard=shard, mesh=run.get("mesh"),
            block_q=run["attn_block_q"], block_k=run["attn_block_k"], layout=sp,
        )
        return x, aux

    def _attn_stack(self, params, x, memory, run, positions, shard=False, sp=None):
        """Every layer (dense, moe, audio), or the vlm's ``n_layers //
        every`` groups of ``every`` layers, each followed by its
        cross-attention block; like the reference, the vlm stack runs
        ``blocks[: n_groups * every]``.  With ``sp`` each block gathers its
        own weights inside its checkpoint.  Returns (x, summed aux)."""
        cfg = self.cfg
        moe = cfg.moe is not None
        every = cfg.xattn_every or cfg.n_layers
        n_groups = cfg.n_layers // every
        blocks = _unstack(params["blocks"], n_groups * every)
        xblocks = _unstack(params["xattn"], n_groups) if cfg.xattn_every else None

        def layer(i, x):
            return self._attn_block(blocks[i], x, run, positions, moe, shard, sp)

        def group(g, x):
            aux = 0.0
            for i in range(g * every, (g + 1) * every):
                x, a = _remat(run, lambda x, i=i: layer(i, x), x)
                aux = aux + a
            if cfg.xattn_every:
                x = B.xattn_block_apply(xblocks[g], cfg, x, memory, attn_impl=run["attn_impl"],
                                        layout=sp)
            return x, aux

        aux = 0.0
        for g in range(n_groups):
            if cfg.xattn_every:
                x, a = _remat(run, lambda x, g=g: group(g, x), x)
            else:
                x, a = group(g, x)
            aux = aux + a
        return x, aux

    def _shared_after(self, i: int) -> bool:
        """Whether the hybrid stack runs its shared attention block after
        layer ``i``: once per full group of ``every`` layers, so a tail of
        ``n_layers % every`` layers runs without it."""
        every = self.cfg.shared_attn_every
        n_head = (self.cfg.n_layers // every) * every
        return (i + 1) % every == 0 and i < n_head

    def _recurrent_stack(self, params, x, run, positions, states, place=None,
                         keep_states=True):
        """rwkv6 layers (ssm), or zamba2's groups of ``every`` mamba2 layers
        each followed by the shared attention block, then the mamba2 tail
        (hybrid).  Returns (x, stacked new states; None without
        ``keep_states``, and then no layer's state outlives it).  In a
        :class:`~repro_torch.models.layers.DSharded` ``place`` ``x`` is the
        rank's d block: each layer gathers its own weights and deals its
        heads (``blocks``' module docstring), each gathering its new state
        whole at its end, and the shared block runs on the residual
        gathered whole, its weights whole and alike on every model rank, the
        rank keeping its d block of its output."""
        cfg = self.cfg
        hybrid = self.block_kind == "mamba2"
        apply = B.mamba2_block_apply if hybrid else B.rwkv6_block_apply
        blocks = _unstack(params["blocks"], cfg.n_layers)
        mesh = _mesh_of(place)

        def layer(i, x):
            st = None if states is None else _layer(states, i)
            x, ns = apply(blocks[i], cfg, x, state=st, scan_impl=run["scan_impl"], layout=place)
            return x, ns if keep_states else None

        def shared(x):
            if place is None:
                return self._attn_block(params["shared_attn"], x, run, positions)[0]
            p = B.whole_block_view(params["shared_attn"], B.attn_block_meta(cfg), mesh)
            x = self._attn_block(p, C.gather(x, mesh, "model", 2, grad="slice"), run,
                                 positions)[0]
            return C.split(x, mesh, "model", 2)

        def group(i0, i1, x):
            new = []
            for i in range(i0, i1):
                x, ns = layer(i, x)
                new.append(ns)
            if hybrid and self._shared_after(i1 - 1):
                x = shared(x)
            return x, new

        # the checkpointed spans: each group of the hybrid's head, else one layer
        every = cfg.shared_attn_every if hybrid else 1
        n_head = (cfg.n_layers // every) * every
        spans = [(i, i + every) for i in range(0, n_head, every)] + \
            [(i, i + 1) for i in range(n_head, cfg.n_layers)]
        new = []
        for i0, i1 in spans:
            x, ns = _remat(run, lambda x, i0=i0, i1=i1: group(i0, i1, x), x)
            new += ns
        if not keep_states:
            return x, None
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
        """(B, S, Vp), or (B, S, n_codebooks, Vp) for audio."""
        cfg = self.cfg
        if cfg.n_codebooks > 1:
            return torch.stack([L.logits_apply(params["embed"], cfg, x, codebook=c)
                                for c in range(cfg.n_codebooks)], dim=2)
        return L.logits_apply(params["embed"], cfg, x)

    # -- loss -----------------------------------------------------------------
    def loss(self, params, batch, *, run=None):
        """The training loss of ``batch``: dict(tokens (B, S), or (B, S,
        n_codebooks) for audio, targets the same, mask (B, S) or absent, and
        the vlm's image tokens ``memory``).  The masked mean cross-entropy
        (:func:`_xent_chunked`) plus 0.01 times the MoE balancing loss, from
        zero recurrent states, as the reference's ``LM.loss``."""
        cfg = self.cfg
        run = {**DEFAULT_RUN, **(run or {})}
        shard = self._check_engine(run, "sp")
        tokens = batch["tokens"]
        place = self._placement(run, tokens.shape[1])
        params = self.mesh_params(params, run)
        states = self.init_recurrent_states(tokens.shape[0], cfg.param_dtype)
        hid, aux, _ = self._forward(params, tokens, batch.get("memory"), run, None, states,
                                    shard, place, keep_states=False)
        targets, mask = batch["targets"], batch.get("mask")
        if place is None:
            tot, cnt = _xent_sums(params["embed"], cfg, hid, targets, mask,
                                  chunk=run["loss_chunk"])
        else:
            # the head gathered once for the forward and once for the
            # backward, alive only while each runs; in the sequence-parallel
            # layout, on the rank's tokens' targets
            if isinstance(place, L.SeqParallel):
                own = slice(place.start, place.start + hid.shape[1])
                targets, mask = targets[:, own], None if mask is None else mask[:, own]
            embed = params["embed"]

            def whole(blocks):
                it = iter(blocks)
                return self._whole({"embed": tree_map(lambda _: next(it), embed)}, "embed",
                                   place.mesh, self._head_leaves(), _view_of(place))

            tot = _GatheredXent.apply(hid, targets, mask, cfg, run["loss_chunk"], whole,
                                      *tree_leaves(embed))
            cnt = _mask_of(hid, mask).sum()
        if run.get("mesh") is None:
            nll = tot / torch.clamp(cnt, min=1.0)
        else:
            # every model rank holds the same tokens but in the
            # sequence-parallel layout
            mesh = run["mesh"]
            axes = (tuple(axis_sizes(mesh)) if isinstance(place, L.SeqParallel)
                    else data_axes(mesh))
            cnt = C.all_reduce(cnt.detach(), mesh, axes)
            nll = C.reduce_forward(tot / torch.clamp(cnt, min=1.0), mesh, axes)
        return nll + 0.01 * aux

    # -- decode ---------------------------------------------------------------
    def decode_init(self, batch: int, max_len: int, *, params=None, memory=None):
        """Allocate the decode cache: the shared length, plus per-layer ring
        buffers of K and V (of capacity ``window`` for sliding-window archs)
        for attention stacks, the stacked recurrent states for ssm, and both
        for hybrid, whose KV buffers hold one entry per occurrence of the
        shared block.  For vlm archs given ``params`` and the image
        ``memory``, the cross-attention K/V are projected here once (``xkv``,
        :meth:`cross_kv`) instead of at every step; without them decode runs
        the text layers alone, as the reference's does.  On a mesh,
        ``launch.shardings.decode_cache`` allocates the rank's blocks."""
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
            if cfg.xattn_every and memory is not None and params is not None:
                cache["xkv"] = self.cross_kv(params, memory)
        else:
            cache["states"] = self.init_recurrent_states(batch, dt)
        if self.block_kind == "mamba2":
            cache["shared_kv"] = kv(cfg.n_layers // cfg.shared_attn_every)
        return cache

    def cross_kv(self, params, memory, *, mesh=None):
        """The vlm's cross-attention K/V heads of the image ``memory`` (B, M,
        d), stacked per cross block.  On ``mesh``, ``params`` are the rank's
        blocks (each block's attention gathered whole) and ``memory`` its
        block of rows and image tokens, which projects to its block of the
        K/V: the image tokens striped over "model"."""
        pairs = []
        for i in range(self.cfg.n_layers // self.cfg.xattn_every):
            p = _layer(params["xattn"], i)
            if mesh is not None:
                p = {"attn": B.whole_block_view(p["attn"], L.attn_meta(self.cfg, cross=True),
                                                mesh)}
            pairs.append(B.xattn_precompute_kv(p, self.cfg, memory))
        return {"k": torch.stack([k for k, _ in pairs]), "v": torch.stack([v for _, v in pairs])}

    def decode_step(self, params, tokens, cache, *, memory=None, run=None):
        """One token per sequence; tokens (B, 1), or (B, 1, n_codebooks) for
        audio.  Returns (logits, cache').  The new K/V rows and recurrent
        states are written into ``cache``'s tensors in place, and ``cache'``
        holds those tensors with the advanced length; a slot's
        ``cache["start"]`` offset masks the KV rows of its predecessor.  The
        vlm's cross attention reads ``cache["xkv"]`` (see
        :meth:`decode_init`); ``memory`` is taken for the reference's
        signature and, as there, not read.  On ``run["mesh"]`` the step runs
        in the striped-cache layout (the module docstring): ``params``,
        ``tokens``, ``cache`` (``start`` too) are the rank's blocks, and the
        logits of the rank's rows come out alike on every model rank.  There
        a cache with K/V rings must carry their global T (``cache["ring"]``,
        :func:`ring_record`; ``launch.shardings.decode_cache`` sets it), and
        its stripes must make it up over "model": a ``ValueError`` otherwise,
        as for a vlm's ``xkv`` whose stripes do not make up its image
        tokens."""
        cfg = self.cfg
        run = {**DEFAULT_RUN, **(run or {})}
        shard = self._check_engine(run, "decode_moe_shardmap")
        mesh = run.get("mesh")
        if mesh is not None:
            self._check_stripes(cache, axis_size(mesh, "model"))
        pos = cache["len"]
        x = L.embed_apply(self._whole(params, "embed", mesh, ("tok",)), cfg, tokens)
        if self.block_kind == "attn":
            if not cfg.rope:
                x = x + L.sinusoid_embed(pos.reshape(1), cfg.d_model)[None].to(x.dtype)
            x = self._attn_decode(params, x, cache, mesh, shard)
        else:
            x = self._recurrent_decode(params, x, cache, mesh)
        x = L.norm_apply(self._whole(params, "ln_f", mesh), cfg, x)
        head = {"embed": self._whole(params, "embed", mesh, self._head_leaves())}
        return self._logits(head, x), {**cache, "len": pos + 1}

    def _check_stripes(self, cache, n: int) -> None:
        """Refuses a decode cache whose K/V rings, or ``xkv``, are not one
        rank's stripes over a model axis of ``n`` > 1 ranks: read as a
        stripe, a whole ring would be written and attended at the wrong
        slots."""
        if n == 1:
            return
        rings = [cache[name]["k"].shape[3] for name in ("kv", "shared_kv") if name in cache]
        ring = cache.get("ring")
        if rings and (ring is None or ring.shape[1] != rings[0] * n):
            raise ValueError(
                f"decode on a mesh reads the cache's K/V rings as this rank's stripes of T "
                f"over \"model\" ({n} ranks): {rings[0]} rows a stripe, and the cache records "
                f"{'no T' if ring is None else f'T {ring.shape[1]}'} (allocate it with "
                f"launch.shardings.decode_cache)")
        if "xkv" in cache and cache["xkv"]["k"].shape[3] * n != self.cfg.n_img_tokens:
            raise ValueError(
                f"decode on a mesh reads the cross K/V as this rank's stripe of the "
                f"{self.cfg.n_img_tokens} image tokens over \"model\" ({n} ranks), not "
                f"{cache['xkv']['k'].shape[3]} (project it with LM.cross_kv(mesh=))")

    def _attn_decode_block(self, p, x, k, v, cache, mesh, moe=False, shard=False):
        """One attention block's decode step against its K/V ring buffers
        (on ``mesh``, the rank's stripe of them)."""
        pos = cache["len"]
        kv = {"k": k, "v": v, "len": pos, "start": cache.get("start")}
        x, _, _ = B.attn_block_apply(p, self.cfg, x, moe=moe, kv_cache=kv, shard=shard,
                                     mesh=mesh if shard else None, layout=_striped(mesh),
                                     positions=pos + torch.arange(x.shape[1], device=x.device))
        return x

    def _attn_decode(self, params, x, cache, mesh, shard=False):
        """Every layer's decode step, or with the vlm's ``xkv`` the group walk
        of :meth:`_attn_stack`, each group's cross-attention block reading
        its precomputed K/V."""
        cfg = self.cfg
        moe = cfg.moe is not None
        cross = bool(cfg.xattn_every) and "xkv" in cache
        every = cfg.xattn_every if cross else cfg.n_layers
        for g in range(cfg.n_layers // every):
            for i in range(g * every, (g + 1) * every):
                x = self._attn_decode_block(_layer(params["blocks"], i), x,
                                            cache["kv"]["k"][i], cache["kv"]["v"][i], cache,
                                            mesh, moe, shard)
            if cross:
                x = B.xattn_block_apply(_layer(params["xattn"], g), cfg, x,
                                        kv_override=(cache["xkv"]["k"][g],
                                                     cache["xkv"]["v"][g]),
                                        layout=_striped(mesh))
        return x

    def _state_dims(self, mesh) -> Dict[str, Any]:
        """{state name: the dim of a layer's state (B, ...) that "model"
        splits, or None} by ``launch.shardings.cache_pspecs``' rule, from
        the whole state's shape."""
        init = B.mamba2_state_init if self.block_kind == "mamba2" else B.rwkv6_state_init
        one = init(self.cfg, 1, self.cfg.param_dtype, "meta")
        n = axis_size(mesh, "model")
        return {name: first_split_dim(t.shape, n, 1) for name, t in one.items()}

    def _recurrent_decode(self, params, x, cache, mesh=None):
        """rwkv6 steps, or the hybrid group walk mirroring
        :meth:`_recurrent_stack`: mamba2 steps, with the shared attention
        block against its per-occurrence KV cache after each full group.  On
        ``mesh`` each layer gathers its weights and its state whole over
        "model", steps as on one device and keeps its own block of the new
        state."""
        cfg = self.cfg
        hybrid = self.block_kind == "mamba2"
        apply = B.mamba2_block_apply if hybrid else B.rwkv6_block_apply
        states = cache["states"]
        split = self._state_dims(mesh) if mesh is not None else {}
        occ = 0
        for i in range(cfg.n_layers):
            p, st = _layer(params["blocks"], i), _layer(states, i)
            if mesh is not None:
                p = B.whole_block_view(p, self._block_meta(), mesh)
                st = {k: t if split[k] is None else C.all_gather(t, mesh, "model", split[k])
                      for k, t in st.items()}
            x, ns = apply(p, cfg, x, state=st)
            del p, st
            if mesh is not None:
                ns = {k: t if split[k] is None else C.own_block(t, mesh, "model", split[k])
                      for k, t in ns.items()}
            _write_state(states, i, ns)
            if hybrid and self._shared_after(i):
                x = self._attn_decode_block(params["shared_attn"], x, cache["shared_kv"]["k"][occ],
                                            cache["shared_kv"]["v"][occ], cache, mesh)
                occ += 1
        return x


# ---------------------------------------------------------------------------
# chunked cross-entropy (full logits never live at once)
# ---------------------------------------------------------------------------

def _xent_chunked(embed_params, cfg: ArchConfig, hidden, targets, mask, *, chunk: int):
    """Masked mean cross-entropy of the logits of ``hidden`` (B, S, d)
    against ``targets`` (B, S), or (B, S, n_codebooks) whose codebooks'
    losses are averaged, weighted by ``mask`` (B, S; all ones when None),
    over sequence chunks: ``chunk`` halved until it divides S, as in the
    reference.  A chunk's f32 logits, with the padded vocab held off by a
    -1e30 penalty, live only inside it: under autograd each chunk runs
    under a checkpoint and is recomputed in the backward."""
    tot, cnt = _xent_sums(embed_params, cfg, hidden, targets, mask, chunk=chunk)
    return tot / torch.clamp(cnt, min=1.0)


def _xent_sums(embed_params, cfg: ArchConfig, hidden, targets, mask, *, chunk: int):
    """(Σ mask × nll, Σ mask) of :func:`_xent_chunked`, whose quotient it
    is (on a mesh the count is summed over the data axes first)."""
    msk = _mask_of(hidden, mask)
    pad = _vocab_pad(cfg, hidden.device)
    tot = cnt = torch.zeros((), device=hidden.device)
    for c in _loss_chunks(hidden.shape[1], chunk):
        m = msk[:, c]
        tot = tot + checkpointed(lambda h, t, m: _xent_chunk(embed_params, cfg, pad, h, t, m),
                                 hidden[:, c], targets[:, c], m)
        cnt = cnt + m.sum()
    return tot, cnt


def _mask_of(hidden, mask):
    """The loss mask in f32 (all ones when None)."""
    if mask is None:
        return torch.ones(hidden.shape[:2], device=hidden.device)
    return mask.to(torch.float32)


def _vocab_pad(cfg: ArchConfig, device):
    """-1e30 on the padded vocab's entries past ``cfg.vocab``, else 0."""
    return torch.where(torch.arange(L.padded_vocab(cfg), device=device) >= cfg.vocab, -1e30, 0.0)


def _loss_chunks(S: int, chunk: int) -> list:
    """The sequence chunks of the loss: ``chunk`` halved until it divides
    S, as in the reference."""
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    return [slice(c0, c0 + chunk) for c0 in range(0, S, chunk)]


class _GatheredXent(torch.autograd.Function):
    """Σ mask × nll of :func:`_xent_sums` in the sequence-parallel layout,
    whose head is gathered from the rank's blocks by ``whole(blocks)``:
    gathered once in the forward (no graph) and once in the backward, where
    each chunk's logits are recomputed and differentiated alone (as the
    chunks' checkpoints do on one device) and the whole head's gradient is
    sent back through the gather (a reduce-scatter).  Neither pass keeps
    the gathered head beyond itself, and the logits are computed twice, as
    on one device."""

    @staticmethod
    def forward(ctx, hidden, targets, mask, cfg, chunk, whole, *blocks):
        ctx.cfg, ctx.chunk, ctx.whole = cfg, chunk, whole
        ctx.save_for_backward(hidden, targets, mask, *blocks)
        with torch.no_grad():
            return _xent_sums(whole(blocks), cfg, hidden, targets, mask, chunk=chunk)[0]

    @staticmethod
    def backward(ctx, g):
        hidden, targets, mask, *blocks = ctx.saved_tensors
        cfg = ctx.cfg
        blocks = [b.detach().requires_grad_() for b in blocks]
        with torch.enable_grad():
            gathered = ctx.whole(blocks)
        leaves = tree_leaves(gathered)
        used = [t.detach().requires_grad_() for t in leaves]
        it = iter(used)
        head = tree_map(lambda _: next(it), gathered)
        msk = _mask_of(hidden, mask)
        pad = _vocab_pad(cfg, hidden.device)
        dhead = [torch.zeros_like(t) for t in used]
        dhidden = []
        for c in _loss_chunks(hidden.shape[1], ctx.chunk):
            h = hidden[:, c].detach().requires_grad_()
            with torch.enable_grad():
                out = _xent_chunk(head, cfg, pad, h, targets[:, c], msk[:, c])
            dh, *dw = torch.autograd.grad(out, [h] + used, g, allow_unused=True)
            dhidden.append(dh)
            for acc, d in zip(dhead, dw):
                if d is not None:
                    acc.add_(d)
        del used, head
        grads = torch.autograd.grad(leaves, blocks, dhead, allow_unused=True)
        return (torch.cat(dhidden, dim=1), None, None, None, None, None) + tuple(grads)


def _xent_chunk(embed_params, cfg: ArchConfig, pad, h, t, m):
    """Σ mask × nll over one chunk."""
    def nll(logits, tgt):
        lg = logits.to(torch.float32) + pad
        gold = torch.gather(lg, -1, tgt.long()[..., None])[..., 0]
        return torch.logsumexp(lg, dim=-1) - gold

    if cfg.n_codebooks > 1:
        out = sum(nll(L.logits_apply(embed_params, cfg, h, codebook=c), t[..., c])
                  for c in range(cfg.n_codebooks)) / cfg.n_codebooks
    else:
        out = nll(L.logits_apply(embed_params, cfg, h), t)
    return torch.sum(out * m)


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
