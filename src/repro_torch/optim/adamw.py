"""AdamW + cosine schedule + global-norm clipping on dict trees of tensors.

Port of ``repro.optim.adamw``, with its rounding: with
``grad_dtype="bfloat16"`` every gradient is cast to bf16 and back to f32
before anything else (in the reference, the compression of the cross-replica
reduction); the global norm is summed over the leaves in sorted-key order,
as ``jax.tree.leaves`` orders a dict; ``m``, ``v`` and the ``master`` weights
are f32, the master a copy even of f32 parameters; the step ``count`` is an
int32 scalar; the parameters are the master rounded to their own dtype.
Everything stays on the parameters' device, the metrics too (0-d tensors),
so a step reads nothing back.

The update is functional, as the reference's: it returns new trees and
leaves the given ones as they are, one leaf at a time.

On a mesh (ZeRO): ``opt_pspecs`` gives the optimizer state the parameters'
specs, so each rank holds and updates its own block of ``m``, ``v`` and the
master.  ``adamw_update(..., mesh=, specs=)`` takes each rank's blocks of
the parameters and of their (already reduced) gradients; only the global
norm needs the others: each rank sums the squares of its blocks, a leaf
whole across some axes counted by the rank at index 0 of them alone, and the
sum is all-reduced over the mesh before the square root, so every rank
clips by the whole tree's norm.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..models.module import tree_leaves, tree_map
from ..parallel import collectives as C
from ..parallel.mesh import axis_sizes
from ..parallel.spec import names

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    grad_dtype: Optional[str] = "bfloat16"
    master_f32: bool = True


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up over ``warmup_steps``, then a cosine decay to 0 at
    ``total_steps``; f32, on ``step``'s device."""
    step = step.to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                    0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(math.pi * t))


def adamw_init(params):
    """Zero f32 moments, an f32 copy of the parameters, and count 0."""
    leaves = tree_leaves(params)
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params),
        "master": tree_map(lambda p: p.detach().to(F32, copy=True), params),
        "count": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    }


def _counted_here(spec, mesh) -> bool:
    """Whether this rank counts a leaf laid out by ``spec`` in the global
    norm: it is at index 0 of every axis the leaf is whole across."""
    named = {a for entry in spec for a in names(entry)}
    return all(mesh.get_local_rank(a) == 0 for a in axis_sizes(mesh) if a not in named)


def adamw_update(cfg: AdamWConfig, params, grads, state, *, mesh=None, specs=None):
    """Returns (new_params, new_state, {"grad_norm", "lr"}).  On a mesh,
    every tree holds this rank's blocks, laid out by ``specs`` (the
    parameters' spec tree)."""
    def f32_grad(g):
        if cfg.grad_dtype == "bfloat16":
            g = g.to(torch.bfloat16)
        return g.to(F32)

    if (mesh is None) != (specs is None):
        raise ValueError("adamw_update on a mesh needs both mesh and specs")
    counted = ([True] * len(tree_leaves(grads)) if mesh is None
               else [_counted_here(s, mesh) for s in tree_leaves(specs)])
    gsq = torch.zeros((), dtype=F32, device=state["count"].device)
    for g, here in zip(tree_leaves(grads), counted):
        if here:
            g = f32_grad(g)
            gsq = gsq + torch.sum(g * g)
    if mesh is not None:
        gsq = C.all_reduce(gsq, mesh, tuple(axis_sizes(mesh)))
    gnorm = torch.sqrt(gsq)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)

    count = state["count"] + 1
    lr = cosine_schedule(cfg, count)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=count.device), count.to(F32))
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=count.device), count.to(F32))

    def leaf(p, g, m, v, master):
        g = f32_grad(g) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * master
        master = master - lr * upd
        return m, v, master, master.to(p.dtype)

    out = tree_map(leaf, params, grads, state["m"], state["v"], state["master"])
    m, v, master, new_params = (tree_map(lambda t, i=i: t[i], out) for i in range(4))
    return new_params, {"m": m, "v": v, "master": master, "count": count}, \
        {"grad_norm": gnorm, "lr": lr}


def opt_pspecs(param_pspecs):
    """Optimizer-state specs mirror the parameter specs (ZeRO)."""
    return {"m": param_pspecs, "v": param_pspecs, "master": param_pspecs, "count": ()}
