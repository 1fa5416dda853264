"""Int8 error-feedback gradient compression for a cross-replica reduction.

Port of ``repro.optim.compress``.  Per tensor: add the carried residual,
agree on a shared scale (the max-abs reduced with MAX over the group, so
every member quantizes alike), quantize to int8 (``torch.round`` rounds
half to even, as ``jnp.round`` does), **sum exactly in int32**, dequantize
and divide by the group's size (the mean), and keep the local quantization
error as the next round's residual.  Every division is rounded once, as in
the reference, on the card too (:func:`_div`), so the results are the
reference's and numpy's bit for bit.

Traffic: an f32 all-reduce moves 2(g-1)/g × 4 B a parameter over each link,
the int8 one 2(g-1)/g × 1 B (+8 B a tensor for the scale): 4× less.  The
int32 sum is exact, so every member gets the same result.

As in the reference, the train step does not call it: it is a utility,
held by its tests.  ``group`` is a ``torch.distributed`` process group
(``mesh.get_group("pod")``, say), whose backend the caller picked.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.module import tree_leaves, tree_map

F32 = torch.float32
_Q = 127.0


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """``a / b`` rounded once, as the reference divides: a Python number is
    made a tensor on ``a``'s device first, since CUDA divides by a host
    scalar as a product with its rounded reciprocal."""
    if not torch.is_tensor(b):
        b = torch.tensor(b, dtype=a.dtype, device=a.device)
    return a / b


def quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 quantization around a (shared) per-tensor scale."""
    return torch.clamp(torch.round(_div(x.to(F32), scale)), -_Q, _Q).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def ef_init(tree):
    """Zero error-feedback residuals shaped like the gradient tree."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=F32, device=g.device), tree)


def compressed_psum(grads, ef, *, group=None):
    """Error-feedback int8 all-reduce over ``group`` (the default group when
    None).  Returns (the mean of the members' gradients, each in its own
    dtype; the new residuals), trees shaped like ``grads``."""
    n = dist.get_world_size(group)

    def one(g, e):
        x = g.to(F32) + e
        amax = torch.max(torch.abs(x)).reshape(1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = _div(torch.clamp(amax[0], min=1e-12), _Q)
        q = quantize(x, scale)
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        mean = _div(dequantize(total, scale), float(n))
        # residual: what this member failed to contribute this round
        return mean.to(g.dtype), x - dequantize(q, scale)

    outs = tree_map(one, grads, ef)
    return tree_map(lambda o: o[0], outs), tree_map(lambda o: o[1], outs)


def compression_ratio(tree) -> float:
    """Bytes(f32 AR) / bytes(int8 AR + scales) for the given tree."""
    leaves = tree_leaves(tree)
    f32_bytes = sum(g.numel() * 4 for g in leaves)
    int8_bytes = sum(g.numel() * 1 + 8 for g in leaves)
    return f32_bytes / int8_bytes
