"""Step builders for training and serving, and the stand-ins of their
inputs.

Port of ``build_run``, ``TRAIN_ACCUM``, ``build_train_step``,
``build_prefill_step``, ``build_decode_step`` and the input-spec builders of
``repro.launch.steps``.  Each builder returns ``(step_fn, model, run)``:

* ``train``   — the loss and its gradients over ``accum`` microbatches,
  accumulated in f32, then the AdamW update;
* ``prefill`` — forward over the full prompt (and the vlm's image tokens,
  ``batch["memory"]``), returns last-token logits;
* ``decode``  — one new token against a KV cache (on a mesh, the cache's
  T striped over "model": ``models/lm.py``'s striped-cache layout).

PyTorch runs eagerly, so the step is the plain function the reference
hands to ``jax.jit``.  The model lives on the card unless ``device`` says
otherwise.

**On a mesh** (``mesh=``, a ``DeviceMesh``, or a ``MeshDescription``
standing for one device, with ``meta`` inputs, for the dry run; FSDP/ZeRO
over the data axes): the step takes this rank's blocks of the parameters
and of the optimizer state (``LM.pspecs``, ``opt_pspecs``) and this rank's
rows of the batch, microbatch by microbatch (``shardings.data_rows``).  The
loss is the global batch's (``LM.loss`` on a mesh); each leaf's gradient
comes out of autograd already reduce-scattered onto the rank's block (the
backward of the forward's gathers: the reference's ``pin_grads``), and
AdamW updates the rank's blocks with the whole tree's norm.  ``build_run``
keeps the mesh and ``sp`` (on by default on a mesh, as in the reference;
off without one, where nothing spans cards), which puts an attention stack
in the sequence-parallel layout of ``models/lm.py`` (each rank its S / M
tokens, each layer's weights gathered inside its checkpoint, the dense FFN
tensor parallel); the data axes, and whether the mesh spans pods, are read
off the mesh wherever they are needed.

``param_specs``, ``opt_state_specs``, ``batch_specs``, ``cache_specs``,
``decode_token_specs`` and ``input_specs`` are the reference's builders of
the same names (``src/repro/launch/steps.py:166-267``): tensors on the
``meta`` device with the reference's shapes and dtypes, keyed as the step's
arguments, which the dry run (``launch/dryrun.py``) hands to the step.
Given a mesh (a ``DeviceMesh`` or a ``MeshDescription``), each leaf has one
rank's block's shape (the reference's ``shard_shape``) and carries its spec
as ``leaf.spec``.  The reference's ``multi_pod=`` flag is the mesh's own
"pod" axis here: a ``MeshDescription`` over ("pod", "data", "model").
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..configs import SHAPES
from ..models import LM
from ..models.config import ArchConfig
from ..models.lm import DEFAULT_RUN
from ..models.module import tree_leaves, tree_map
from ..optim import AdamWConfig, adamw_update, opt_pspecs
from ..parallel.mesh import is_multi_pod
from ..parallel.spec import local_shape
from .shardings import batch_pspecs, cache_pspecs

META = torch.device("meta")


def build_run(cfg: ArchConfig, *, mesh=None,
              run_overrides: Dict[str, Any] = None) -> Dict[str, Any]:
    """The train step's run: the chunked attention, per-layer remat and the
    cross-entropy in chunks of 512, as the reference's ``build_run``, with
    ``sp`` and the ``mesh``.  ``sp`` is on by default on a mesh, as the
    reference's default, and off without one: on a mesh it runs an
    attention stack in the sequence-parallel layout and a recurrent stack
    in the d-sharded one (``models/lm.py``), and ``sp=False`` there gathers
    the dense weights whole for the step.  The
    reference's ``attn_seq_shard`` (its pins of the sequence-parallel
    attention, which this layout is) and ``attn_block_q`` (its one q block
    of up to 4,096 in the plain attention, for fewer partial dK/dV
    reductions) are taken from ``run_overrides`` and change no number: the
    q blocking changes no value, and the default blocks of 512 keep the
    backward's recomputed scores 8 times smaller and skip the key blocks the
    causal mask hides whole."""
    return {**DEFAULT_RUN, "attn_impl": "chunked", "remat": True, "loss_chunk": 512,
            "sp": mesh is not None, "mesh": mesh,
            **(run_overrides or {})}


# the reference's per-arch microbatch (gradient-accumulation) factors of its
# train_4k cell
TRAIN_ACCUM = {
    "granite-moe-3b-a800m": 2,
    "mixtral-8x7b": 2,
    "command-r-plus-104b": 8,
    "starcoder2-15b": 2,
    "zamba2-1.2b": 2,
}


def build_train_step(cfg: ArchConfig, *, opt_cfg: AdamWConfig = None, accum: int = None,
                     run_overrides: dict = None, device=None, mesh=None):
    """``train_step(params, opt_state, batch) -> (new_params, new_opt,
    {"loss", "grad_norm", "lr"})``, every result on the model's device.

    ``batch`` holds tokens, targets and mask (numpy arrays or tensors; the
    vlm's ``memory`` too), split along the batch into ``accum`` microbatches
    of consecutive rows.  Each microbatch's gradients (``torch.autograd.grad``
    of ``LM.loss`` over the parameter leaves) are added into f32 zeros, and
    the sum and the loss divided by ``accum``, as the reference's scan does;
    with ``accum`` 1 the gradients go to the update as autograd gives them.
    The given trees are left as they are.

    The step's parts are its attributes, for the dry run, which counts the
    loop's body once and weights it by ``accum``: ``train_step.begin(params)``
    (the f32 zeros), ``train_step.microbatch(params, mb, gsum)`` (one
    microbatch's loss; its gradients added into ``gsum``) and
    ``train_step.finish(params, opt_state, gsum, loss_sum)`` (the division
    and the update); ``train_step.accum`` is ``accum``.

    With ``mesh``, every tree holds this rank's blocks and ``batch`` its rows
    (see the module's docstring); the metrics are the global ones on every
    rank."""
    model = LM(cfg, device)
    opt_cfg = opt_cfg or AdamWConfig()
    run = build_run(cfg, mesh=mesh, run_overrides=run_overrides)
    accum = accum or TRAIN_ACCUM.get(cfg.name, 1)
    specs = None if mesh is None else _pspecs(model, mesh)

    def grads_of(params, mb):
        leaves = tree_leaves(params)
        wrt = [t.detach().requires_grad_() for t in leaves]
        it = iter(wrt)
        loss = model.loss(tree_map(lambda _: next(it), params), mb, run=run)
        g = torch.autograd.grad(loss, wrt, allow_unused=True)
        return loss.detach(), [torch.zeros_like(t) if d is None else d for t, d in zip(wrt, g)]

    def update(params, grads, opt_state, loss):
        it = iter(grads)
        new_params, new_opt, metrics = adamw_update(
            opt_cfg, params, tree_map(lambda _: next(it), params), opt_state, mesh=mesh,
            specs=specs)
        return new_params, new_opt, {"loss": loss, **metrics}

    def begin(params):
        return [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                for t in tree_leaves(params)]

    def microbatch(params, mb, gsum):
        with torch.enable_grad():
            loss, g = grads_of(params, mb)
        for acc, t in zip(gsum, g):
            acc.add_(t)
        return loss

    def finish(params, opt_state, gsum, loss_sum):
        for t in gsum:
            t.div_(accum)
        return update(params, gsum, opt_state, loss_sum / accum)

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                    device=model.device) for k, v in batch.items()}
        n = next(iter(batch.values())).shape[0]
        if n % accum:
            raise ValueError(f"batch of {n} rows does not split into {accum} microbatches")
        if accum == 1:
            with torch.enable_grad():
                loss, grads = grads_of(params, batch)
            return update(params, grads, opt_state, loss)
        rows = n // accum
        gsum, loss = begin(params), 0.0
        for i in range(accum):
            loss = loss + microbatch(params, {k: v[i * rows:(i + 1) * rows]
                                              for k, v in batch.items()}, gsum)
        return finish(params, opt_state, gsum, loss)

    train_step.begin, train_step.microbatch, train_step.finish = begin, microbatch, finish
    train_step.accum = accum
    return train_step, model, run


def build_prefill_step(cfg: ArchConfig, *, run_overrides: dict = None, device=None,
                       mesh=None):
    """``prefill_step(params, batch) -> last-token logits``; on a ``mesh``
    (``sp`` on, as the reference's run), this rank's blocks and rows (and
    its block of the vlm's image memory), the logits on every rank."""
    model = LM(cfg, device)
    run = {**DEFAULT_RUN, **({} if mesh is None else {"mesh": mesh, "sp": True}),
           **(run_overrides or {})}

    @torch.no_grad()
    def prefill_step(params, batch):
        # zero recurrent states for ssm/hybrid, as the reference passes
        states = model.init_recurrent_states(batch["tokens"].shape[0], cfg.param_dtype)
        return model.prefill(params, batch["tokens"], memory=batch.get("memory"), run=run,
                             states=states)[0]

    return prefill_step, model, run


def build_decode_step(cfg: ArchConfig, *, run_overrides: dict = None, device=None,
                      mesh=None):
    """``decode_step(params, tokens, cache, memory=None) -> (logits,
    cache')``.  On a ``mesh``, this rank's blocks of the parameters, its
    rows of the tokens and its blocks of the cache (``shardings.decode_cache``
    allocates them), in the striped-cache layout of ``models/lm.py``; the
    logits of the rank's rows on every model rank.  An MoE model there runs
    its FFN as ``moe_apply_shardmap`` (``decode_moe_shardmap`` on, token-local
    capacity over the rank's rows), where the reference's ``build_run``
    leaves that knob off and lets GSPMD dispatch globally: the port has no
    global dispatch on a mesh."""
    model = LM(cfg, device)
    placed = {} if mesh is None else {"mesh": mesh, "decode_moe_shardmap": cfg.moe is not None}
    run = {**DEFAULT_RUN, **placed, **(run_overrides or {})}

    @torch.no_grad()
    def decode_step(params, tokens, cache, memory=None):
        return model.decode_step(params, tokens, cache, memory=memory, run=run)

    return decode_step, model, run


# ---------------------------------------------------------------------------
# input stand-ins on the meta device: the global shapes, or with a mesh one
# rank's block's, each leaf carrying its spec
# ---------------------------------------------------------------------------

def _cell(shape) -> dict:
    """A name of ``SHAPES``, or a dict with its keys (``seq_len``,
    ``global_batch``, ``kind``)."""
    return SHAPES[shape] if isinstance(shape, str) else shape


def _meta(shape, dtype, mesh=None, spec=None) -> torch.Tensor:
    if mesh is None:
        return torch.empty(shape, dtype=dtype, device=META)
    t = torch.empty(local_shape(shape, spec, mesh), dtype=dtype, device=META)
    t.spec = tuple(spec)
    return t


def _tree_meta(shapes, specs, mesh):
    """Global-shape stand-ins as blocks of ``mesh`` by ``specs`` (unchanged
    without a mesh)."""
    if mesh is None:
        return shapes
    return tree_map(lambda t, s: _meta(tuple(t.shape), t.dtype, mesh, s), shapes, specs)


def _pspecs(model, mesh):
    return model.pspecs(multi_pod=mesh is not None and is_multi_pod(mesh))


def param_specs(cfg: ArchConfig, mesh=None):
    model = LM(cfg, META)
    return _tree_meta(model.shapes(), _pspecs(model, mesh), mesh)


def opt_state_specs(cfg: ArchConfig, mesh=None):
    """``adamw_init``'s tree: f32 ``m``, ``v`` and ``master``, int32 ``count``."""
    model = LM(cfg, META)
    pshapes = model.shapes()

    def f32(t):
        return _meta(t.shape, torch.float32)

    shapes = {"m": tree_map(f32, pshapes), "v": tree_map(f32, pshapes),
              "master": tree_map(f32, pshapes), "count": _meta((), torch.int32)}
    return _tree_meta(shapes, opt_pspecs(_pspecs(model, mesh)), mesh)


def batch_specs(cfg: ArchConfig, shape, mesh=None):
    sh = _cell(shape)
    B, S = sh["global_batch"], sh["seq_len"]
    specs = batch_pspecs(cfg, B, mesh) if mesh is not None else {}
    tok_shape = (B, S) if cfg.n_codebooks == 1 else (B, S, cfg.n_codebooks)
    out = {"tokens": _meta(tok_shape, torch.int32, mesh, specs.get("tokens")),
           "targets": _meta(tok_shape, torch.int32, mesh, specs.get("tokens")),
           "mask": _meta((B, S), torch.float32, mesh, specs.get("mask"))}
    if cfg.xattn_every:
        out["memory"] = _meta((B, cfg.n_img_tokens, cfg.d_model), cfg.param_dtype, mesh,
                              specs.get("memory"))
    return out


def cache_specs(cfg: ArchConfig, shape, mesh=None):
    """The decode cache of ``LM.decode_init`` (without the vlm's
    precomputed cross K/V, as the reference's ``eval_shape`` of it)."""
    sh = _cell(shape)
    B = sh["global_batch"]
    shapes = LM(cfg, META).decode_init(B, sh["seq_len"])
    if mesh is None:
        return shapes
    return _tree_meta(shapes, cache_pspecs(cfg, shapes, B, mesh), mesh)


def decode_token_specs(cfg: ArchConfig, shape, mesh=None):
    B = _cell(shape)["global_batch"]
    spec = batch_pspecs(cfg, B, mesh)["tokens"] if mesh is not None else None
    return _meta((B, 1) if cfg.n_codebooks == 1 else (B, 1, cfg.n_codebooks), torch.int32,
                 mesh, spec)


def input_specs(cfg: ArchConfig, shape, mesh=None):
    """Everything the cell's step takes, as its keyword arguments."""
    sh = _cell(shape)
    if sh["kind"] == "train":
        return {"params": param_specs(cfg, mesh),
                "opt_state": opt_state_specs(cfg, mesh),
                "batch": batch_specs(cfg, sh, mesh)}
    if sh["kind"] == "prefill":
        return {"params": param_specs(cfg, mesh), "batch": batch_specs(cfg, sh, mesh)}
    out = {"params": param_specs(cfg, mesh),
           "tokens": decode_token_specs(cfg, sh, mesh),
           "cache": cache_specs(cfg, sh, mesh)}
    if cfg.xattn_every:
        spec = (batch_pspecs(cfg, sh["global_batch"], mesh)["memory"]
                if mesh is not None else None)
        out["memory"] = _meta((sh["global_batch"], cfg.n_img_tokens, cfg.d_model),
                              cfg.param_dtype, mesh, spec)
    return out
