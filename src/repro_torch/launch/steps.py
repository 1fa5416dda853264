"""Step builders for serving.

Port of ``build_prefill_step`` and ``build_decode_step`` of
``repro.launch.steps``.  Each returns ``(step_fn, model, run)``:

* ``prefill`` — forward over the full prompt (and the vlm's image tokens,
  ``batch["memory"]``), returns last-token logits;
* ``decode``  — one new token against a KV cache.

PyTorch runs eagerly, so the step is the plain function the reference
hands to ``jax.jit``; the mesh, sharding and remat settings of the
reference's ``build_run`` have no meaning on one card.  The model lives on
the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import torch

from ..models import LM
from ..models.config import ArchConfig
from ..models.lm import DEFAULT_RUN


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
