"""Public entry point for attention, forward and, under autograd, backward.

Dispatch by the tensors' device: a CUDA tensor launches the kernel, a CPU
tensor takes the plain chunked version (``ref.mha_chunked``).
``impl="reference"`` forces the plain version on any device (the comparison
in ``chip_smoke.py`` uses it).  k positions count from 0 on both routes, as
in the TPU kernel and ``mha_reference``; q positions from ``q_offset``, 0 by
default (the whole sequence's q, as there), a rank's first token in the
sequence-parallel layout, whose q block attends over every key (the
reference's ``mha_chunked(q_offset=...)``).  ``block_q`` and ``block_k``
size the plain version's chunks; the kernel's tiles are fixed.

Gradients.  ``repro`` has no backward kernel: its train step runs the plain
chunked attention (``attn_impl="chunked"``) and XLA differentiates it.  On
the card, where grad mode is on and q, k or v requires grad, the kernel runs
inside :class:`KernelAttention`, whose forward is the kernel and whose
backward recomputes ``ref.mha_chunked`` on the saved inputs, q block by q
block, and differentiates it (``ref.mha_chunked_vjp``): the port's
counterpart of XLA's autodiff of the same plain formulation, not a
stand-in for a TPU kernel.  Without grad the raw kernel wrapper runs, as
before.  An output without a ``grad_fn`` where an input requires grad
raises.  A hand-written backward kernel is later work (ROADMAP.md queue 2).
"""

from __future__ import annotations

import torch

from .. import _grad
from . import kernel as _kernel
from . import ref as _ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: int | None = None, sm_scale: float | None = None,
              impl: str | None = None, block_q: int = 512, block_k: int = 512,
              q_offset: int = 0) -> torch.Tensor:
    if impl == "reference" or (impl is None and not q.is_cuda):
        return _ref.mha_chunked(q, k, v, causal=causal, window=window, sm_scale=sm_scale,
                                block_q=block_q, block_k=block_k, q_offset=q_offset)
    if impl is not None:
        raise ValueError(f"unknown impl {impl!r}")
    return kernel_route(q, k, v, causal=causal, window=window, sm_scale=sm_scale,
                        block_q=block_q, block_k=block_k, q_offset=q_offset)


def kernel_route(q, k, v, *, causal=True, window=None, sm_scale=None, block_q=512, block_k=512,
                 q_offset=0):
    """The kernel; under autograd, the kernel inside :class:`KernelAttention`
    (``block_q`` and ``block_k`` chunk its backward's plain recompute)."""
    opts = {"causal": causal, "window": window, "sm_scale": sm_scale, "q_offset": q_offset}
    if not _grad.needs_grad(q, k, v):
        return _kernel.flash_attention(q, k, v, **opts)
    out = KernelAttention.apply(q, k, v, opts, {"block_q": block_q, "block_k": block_k})
    return _grad.require_grad_fn("flash_attention", out, q, k, v)


class KernelAttention(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: the gradient of the plain
    ``ref.mha_chunked`` on the same inputs (see the module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, opts, chunks):
        ctx.save_for_backward(q, k, v)
        ctx.plain_opts = {**opts, **chunks}
        return _kernel.flash_attention(q, k, v, **opts)

    @staticmethod
    def backward(ctx, grad_out):
        dq, dk, dv = _ref.mha_chunked_vjp(*ctx.saved_tensors, grad_out, **ctx.plain_opts)
        return dq, dk, dv, None, None
