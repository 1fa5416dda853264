"""Segmented-scan building blocks for the wait-free combine engine.

Port of ``repro.core.scanutils``.  The paper's helping mechanism becomes
function composition along the phase-sorted op sequence; both state machines
involved are tiny (2-state liveness, 1-bit edge validity), their transitions
compose associatively, and every segment head is replaced by a constant
function, so one plain inclusive scan resolves all segments in O(log n)
depth — the dataflow analogue of wait-freedom.

torch has no ``associative_scan``, so :func:`associative_scan` is a
Hillis–Steele scan: log2(n) doubling steps, each one ``combine`` of the
sequence with itself shifted.  Every monoid here is exact int/bool, so the
result equals JAX's whatever the association order.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

Elems = Tuple[torch.Tensor, ...]


def associative_scan(combine: Callable[[Elems, Elems], Elems], elems: Elems) -> Elems:
    """Inclusive scan along axis 0 of a tuple of equal-length tensors.

    ``combine(prev, next)`` must be associative; at each step every position
    ``i >= offset`` becomes ``combine(x[i - offset], x[i])``."""
    n = elems[0].shape[0]
    offset = 1
    while offset < n:
        prev = tuple(e[:-offset] for e in elems)
        nxt = tuple(e[offset:] for e in elems)
        merged = combine(prev, nxt)
        elems = tuple(torch.cat([e[:offset], m]) for e, m in zip(elems, merged))
        offset *= 2
    return elems


def compose_fnpair(a: Elems, b: Elems) -> Elems:
    """Compose 2-state transition functions b∘a.

    Elements are pairs (f0, f1) = (f(state=0), f(state=1)), int32 in {0,1}.
    """
    a0, a1 = a
    b0, b1 = b
    c0 = torch.where(a0 == 1, b1, b0)
    c1 = torch.where(a1 == 1, b1, b0)
    return (c0, c1)


def scan_fnpairs(f0: torch.Tensor, f1: torch.Tensor) -> Elems:
    """Inclusive scan of function-pair composition along axis 0."""
    return associative_scan(compose_fnpair, (f0, f1))


def scan_last_set(payload: Elems, set_flag: torch.Tensor) -> Tuple[Elems, torch.Tensor]:
    """Inclusive last-set scan along axis 0: every position reads the most
    recent element whose ``set`` flag is true.  ``payload`` is a tuple of
    [n] tensors."""
    k = len(payload)

    def combine(a: Elems, b: Elems) -> Elems:
        fb = b[k]
        out = tuple(torch.where(fb, y, x) for x, y in zip(a[:k], b[:k]))
        return out + (a[k] | fb,)

    res = associative_scan(combine, tuple(payload) + (set_flag,))
    return res[:k], res[k]


def seg_cumsum_exclusive(x: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative sum within segments delimited by ``heads``
    (``heads[i]`` marks the first element of a segment)."""

    def combine(a: Elems, b: Elems) -> Elems:
        va, fa = a
        vb, fb = b
        return (torch.where(fb, vb, va + vb), fa | fb)

    incl, _ = associative_scan(combine, (x, heads))
    return incl - x


def shift_right(x: torch.Tensor, fill) -> torch.Tensor:
    """x[i-1] with x[0] = fill (for 'value at previous sorted position')."""
    head = torch.full((1,) + tuple(x.shape[1:]), fill, dtype=x.dtype, device=x.device)
    return torch.cat([head, x[:-1]])
