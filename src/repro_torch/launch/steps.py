"""Step builders for training and serving.

Port of ``build_run``, ``TRAIN_ACCUM``, ``build_train_step``,
``build_prefill_step`` and ``build_decode_step`` of ``repro.launch.steps``.
Each builder returns ``(step_fn, model, run)``:

* ``train``   — the loss and its gradients over ``accum`` microbatches,
  accumulated in f32, then the AdamW update;
* ``prefill`` — forward over the full prompt (and the vlm's image tokens,
  ``batch["memory"]``), returns last-token logits;
* ``decode``  — one new token against a KV cache.

PyTorch runs eagerly, so the step is the plain function the reference
hands to ``jax.jit``.  The reference's mesh and sharding settings (``sp``,
``dp_axes``, ``attn_seq_shard``, pinning the gradients to the parameters'
layout) and its input-spec builders have no meaning on one card and are not
carried over; a ``run`` may still name them.  The model lives on the card
unless ``device`` says otherwise.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..models import LM
from ..models.config import ArchConfig
from ..models.lm import DEFAULT_RUN
from ..models.module import tree_leaves, tree_map
from ..optim import AdamWConfig, adamw_update


def build_run(cfg: ArchConfig, *, run_overrides: Dict[str, Any] = None) -> Dict[str, Any]:
    """The train step's run: the chunked attention, per-layer remat and the
    cross-entropy in chunks of 512, as the reference's ``build_run``.  Its
    one q block of up to 4,096 in the plain attention (fewer partial dK/dV
    reductions under its sequence-parallel layout) is not carried over: the
    q blocking changes no number, and on one card blocks of 512 keep the
    backward's recomputed scores 8 times smaller and skip the key blocks
    the causal mask hides whole."""
    return {**DEFAULT_RUN, "attn_impl": "chunked", "remat": True, "loss_chunk": 512,
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
                     run_overrides: dict = None, device=None):
    """``train_step(params, opt_state, batch) -> (new_params, new_opt,
    {"loss", "grad_norm", "lr"})``, every result on the model's device.

    ``batch`` holds tokens, targets and mask (numpy arrays or tensors; the
    vlm's ``memory`` too), split along the batch into ``accum`` microbatches
    of consecutive rows.  Each microbatch's gradients (``torch.autograd.grad``
    of ``LM.loss`` over the parameter leaves) are added in f32, and the sum
    and the loss divided by ``accum``, as the reference does; with ``accum``
    1 the gradients go to the update as autograd gives them.  The given
    trees are left as they are."""
    model = LM(cfg, device)
    opt_cfg = opt_cfg or AdamWConfig()
    run = build_run(cfg, run_overrides=run_overrides)
    accum = accum or TRAIN_ACCUM.get(cfg.name, 1)

    def grads_of(params, mb):
        leaves = tree_leaves(params)
        wrt = [t.detach().requires_grad_() for t in leaves]
        it = iter(wrt)
        loss = model.loss(tree_map(lambda _: next(it), params), mb, run=run)
        g = torch.autograd.grad(loss, wrt, allow_unused=True)
        return loss.detach(), [torch.zeros_like(t) if d is None else d for t, d in zip(wrt, g)]

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v,
                                    device=model.device) for k, v in batch.items()}
        n = next(iter(batch.values())).shape[0]
        if n % accum:
            raise ValueError(f"batch of {n} rows does not split into {accum} microbatches")
        with torch.enable_grad():
            if accum == 1:
                loss, grads = grads_of(params, batch)
            else:
                rows = n // accum
                loss, grads = 0.0, None
                for i in range(accum):
                    l, g = grads_of(params, {k: v[i * rows:(i + 1) * rows]
                                             for k, v in batch.items()})
                    loss = loss + l
                    if grads is None:
                        grads = [t.to(torch.float32) for t in g]
                    else:
                        for acc, t in zip(grads, g):
                            acc.add_(t)
                    del g
                loss = loss / accum
                for t in grads:
                    t.div_(accum)
        it = iter(grads)
        new_params, new_opt, metrics = adamw_update(
            opt_cfg, params, tree_map(lambda _: next(it), params), opt_state)
        return new_params, new_opt, {"loss": loss, **metrics}

    return train_step, model, run


def build_prefill_step(cfg: ArchConfig, *, run_overrides: dict = None, device=None):
    model = LM(cfg, device)
    run = {**DEFAULT_RUN, **(run_overrides or {})}

    @torch.no_grad()
    def prefill_step(params, batch):
        # zero recurrent states for ssm/hybrid, as the reference passes
        states = model.init_recurrent_states(batch["tokens"].shape[0], cfg.param_dtype)
        hid, _, _ = model.hidden_states(params, batch["tokens"], memory=batch.get("memory"),
                                        run=run, states=states)
        return model._logits(params, hid[:, -1:])

    return prefill_step, model, run


def build_decode_step(cfg: ArchConfig, *, run_overrides: dict = None, device=None):
    model = LM(cfg, device)
    run = {**DEFAULT_RUN, **(run_overrides or {})}

    @torch.no_grad()
    def decode_step(params, tokens, cache, memory=None):
        return model.decode_step(params, tokens, cache, memory=memory, run=run)

    return decode_step, model, run
