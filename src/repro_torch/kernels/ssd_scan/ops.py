"""Public entry point for the SSD / gated linear-attention scan, forward and,
under autograd, backward.

Dispatch by the tensors' device: a CUDA tensor launches the kernel, a CPU
tensor takes the plain chunked version (``ref.linear_scan_chunked``).
``impl="reference"`` forces the plain version on any device (the
comparison in ``chip_smoke.py`` uses it).  The plain version computes the
per-channel formula whatever ``scalar_decay`` says, as the reference's
chunked version does; the kernel with ``scalar_decay`` reads the decay of
channel 0 only, which is exact where w is one value per (b, h, t) broadcast
over K (Mamba-2).  With ``scalar_decay`` w may also be that one value, as
(B, H, S, 1): the kernel then reads only it, and the plain version
broadcasts it over K.

With ``h0=None`` and ``return_state=False`` this is the function of
``repro.kernels.ssd_scan.kernel.ssd_scan``.  ``h0`` (f32 (B, H, K, V)) is
the state to start from, and ``return_state`` also returns the f32 final
state, as ``linear_scan_chunked`` does for the reference's blocks.

Gradients.  ``repro`` has no backward kernel: its recurrent blocks call the
plain ``linear_scan_chunked`` and XLA differentiates it, chunk by chunk.  On
the card, where grad mode is on and an input requires grad, the kernel runs
inside :class:`KernelScan`, whose forward is the kernel and whose backward
recomputes ``ref.linear_scan_chunked`` (with ``h0`` and the final state) on
the saved inputs, chunk by chunk from its carried states, and
differentiates it (``ref.linear_scan_chunked_vjp``): the port's
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


def ssd_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, *,
             chunk: int = 64, scalar_decay: bool = False, strict: bool = False,
             h0: torch.Tensor | None = None, return_state: bool = False,
             impl: str | None = None):
    """Returns y (B, H, S, V), or (y, final state) with ``return_state``."""
    opts = {"chunk": chunk, "scalar_decay": scalar_decay, "strict": strict,
            "return_state": return_state}
    if impl == "reference" or (impl is None and not q.is_cuda):
        return _plain(q, k, v, w, h0, **opts)
    if impl is not None:
        raise ValueError(f"unknown impl {impl!r}")
    return kernel_route(q, k, v, w, h0, **opts)


def _plain(q, k, v, w, h0, *, chunk, scalar_decay, strict, return_state):
    if scalar_decay:
        w = w.expand_as(q)
    y, hT = _ref.linear_scan_chunked(q, k, v, w, h0=h0, chunk=chunk, strict=strict)
    return (y, hT) if return_state else y


def kernel_route(q, k, v, w, h0=None, **opts):
    """The kernel; under autograd, the kernel inside :class:`KernelScan`."""
    if not _grad.needs_grad(q, k, v, w, h0):
        return _kernel.ssd_scan(q, k, v, w, h0=h0, **opts)
    out = KernelScan.apply(q, k, v, w, h0, opts)
    _grad.require_grad_fn("ssd_scan", out[0] if opts["return_state"] else out,
                          q, k, v, w, h0)
    return out


class KernelScan(torch.autograd.Function):
    """Forward: the CUDA kernel.  Backward: the gradient of the plain
    ``ref.linear_scan_chunked`` on the same inputs (see the module
    docstring).  An output that got no gradient (the final state of a
    loss that drops it) arrives as None and is left out."""

    @staticmethod
    def forward(ctx, q, k, v, w, h0, opts):
        ctx.save_for_backward(q, k, v, w, h0)
        ctx.opts = opts
        ctx.set_materialize_grads(False)
        return _kernel.ssd_scan(q, k, v, w, h0=h0, **opts)

    @staticmethod
    def backward(ctx, grad_y, grad_hT=None):
        grads = _ref.linear_scan_chunked_vjp(*ctx.saved_tensors, grad_y, grad_hT,
                                             chunk=ctx.opts["chunk"], strict=ctx.opts["strict"])
        return (*grads, None)
