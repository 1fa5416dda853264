"""Gradients through the hand-written kernels.

``repro`` has no backward kernel: its train step reaches no Pallas kernel
(``attn_impl="chunked"`` selects the plain chunked attention, the recurrent
blocks call the plain chunked scan) and XLA differentiates that plain code,
each chunk body under ``jax.checkpoint``.  The port's forward on the card is
the CUDA kernel, and the kernel's wrapper hands back a tensor without a
``grad_fn``.  Each kernel family's ``ops.py`` therefore wraps its kernel in a
``torch.autograd.Function`` whose backward recomputes the plain version on
the saved inputs, block by block, and differentiates it (the ``*_vjp`` of
the family's ``ref.py``): the port's counterpart of XLA's autodiff of the
same plain formulation, not a stand-in for a TPU kernel.  This module holds
what the families share: :func:`needs_grad`, :func:`require_grad_fn` (an
output that lost its gradient raises) and :func:`checkpointed`, the
counterpart of the reference's ``jax.checkpoint`` around a chunk body or a
layer.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def needs_grad(*tensors) -> bool:
    """Whether autograd records an op on ``tensors``: grad mode is on and
    one of them requires grad (None entries are skipped)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def checkpointed(fn, *args):
    """``fn(*args)``; where autograd records it (grad mode on and a tensor
    among ``args`` requiring grad), under a non-reentrant
    ``torch.utils.checkpoint``, so that its intermediates are recomputed in
    the backward instead of kept.  Tensors ``fn`` reads from its closure get
    their gradients either way; the checkpoint only saves memory."""
    if not needs_grad(*(a for a in args if isinstance(a, torch.Tensor))):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def require_grad_fn(name: str, out: torch.Tensor, *inputs) -> torch.Tensor:
    """``out``; raises if one of ``inputs`` requires grad under grad mode and
    ``out`` carries no ``grad_fn`` (its gradient would be silently lost)."""
    if needs_grad(*inputs) and out.grad_fn is None:
        raise RuntimeError(f"{name}: the kernel's output carries no grad_fn while an input "
                           "requires grad")
    return out
