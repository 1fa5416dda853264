"""Execution-weighted op-cost model of an eager PyTorch step.

The port's counterpart of ``repro.launch.hloparse``.  The reference parses
the compiled HLO module, multiplies each ``while`` body by its trip count and
models each op's flops, bytes and collectives.  PyTorch has no HLO: it
dispatches every op of every loop iteration, so a :class:`TorchDispatchMode`
that sees each aten op as it is dispatched counts the loops by nature.
:func:`count` runs a function under that mode; ``weight`` multiplies what it
counted, as ``hloparse`` multiplies a while body by its trip count (the dry
run counts one microbatch of a train step and weights it by the accumulation
count).

Per-op rules (``hloparse._op_cost``):

* a dot (``mm``, ``bmm``, ``addmm``, ``baddbmm``, ``addbmm``, ``mv``,
  ``dot``; ``einsum``, ``matmul`` and ``linear`` dispatch to these):
  ``2 * |result| * K``;
* ``convolution``: ``2 * |result| * (C_in / groups) * prod(kernel)``
  (``convolution_backward`` that once for each gradient it gives);
* elementwise arithmetic: ``|result|``; of it, the transcendentals (exp,
  tanh, log, rsqrt, sqrt, pow, sigmoid, sin, cos, expm1, log1p, and the
  activations built on them) also count as such;
* reductions (and the softmaxes, ``logsumexp``, ``cumsum``): ``|operand|``;
* bytes: each op that is not free, its tensor operands plus its results,
  each counted once at its footprint (a broadcast dimension of stride 0
  read once).  Free ops are views, metadata and allocations without a
  write (``empty``), as ``hloparse._FREE`` holds plumbing; everything else
  (copies, casts, gathers, scatters, sorts, fills) counts bytes only;
* collectives: the ``_c10d_functional`` and ``c10d`` ops, and the
  ``repro_mesh`` ops that ``parallel/collectives.py`` dispatches for one
  device of a ``MeshDescription`` (the dry run per device), result bytes by
  kind (an all-gather its gathered bytes, a reduce-scatter its scattered
  block's, as the reference's ``collective_bytes`` counts its HLO; the
  port's own reduce-scatter is an all-reduce and a slice, counted so), one
  site each (none on one card).

Two keys have meaning only in eager PyTorch: ``ops``, the ops that are not
free (each one launch or more on the card, so they predict the launches),
and ``top``, the aten ops that weigh most by flops and by bytes, in place of
the HLO ``op_name`` sites.

Memory, as ``memory_analysis()`` gives it: the bytes alive at each moment,
keyed by storage (views share a storage, and a meta tensor has no data
pointer): the arguments' storages, plus each op's new output storages until
they are freed (a finalizer on the storage).  ``argument_bytes`` are those
of the arguments that some op reads (``jax.jit`` drops the others),
``output_bytes`` the result's, ``alias_bytes`` those of the result that are
arguments' storages (caches written in place), and ``temp_bytes`` the peak alive
less the arguments.  On the ``meta`` device nothing is
allocated, and the kernels' ``ops.py`` take their plain versions there, so
the count is of the arithmetic, whatever implements it on the card.
"""

from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Any, Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "allreduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
    "send": "collective-permute", "recv_": "collective-permute",
    "all_gather": "all-gather", "all_reduce_": "all-reduce",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d", "repro_mesh")
TOP_OPS = 12

_DOT = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv", "dot", "vdot"}
_TRANSCENDENTAL = {
    "exp", "exp2", "tanh", "log", "log2", "log10", "rsqrt", "sqrt", "pow", "sigmoid",
    "sin", "cos", "tan", "expm1", "log1p", "erf", "silu", "gelu", "softplus", "mish",
    "silu_backward", "gelu_backward", "softplus_backward", "logit", "atan", "atan2",
}
_ELEMENTWISE = _TRANSCENDENTAL | {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "maximum", "minimum", "fmax", "fmin",
    "clamp", "clamp_min", "clamp_max", "where", "eq", "ne", "lt", "le", "gt", "ge",
    "logical_and", "logical_or", "logical_not", "logical_xor", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "sign", "floor", "ceil", "round",
    "trunc", "remainder", "fmod", "reciprocal", "relu", "threshold_backward",
    "masked_fill", "lerp", "addcmul", "addcdiv", "sigmoid_backward", "tanh_backward",
    "square", "hardtanh", "leaky_relu", "isnan", "isinf", "nan_to_num",
}
_REDUCTION = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "var", "std", "var_mean",
    "std_mean", "norm", "linalg_vector_norm", "logsumexp", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "cumsum", "cumprod",
    "argmax", "argmin", "any", "all", "nansum",
}
_SOFTMAX = {"_softmax", "_log_softmax", "logsumexp"}  # an exp an element of the operand
_FREE = {
    "detach", "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "alias", "lift_fresh", "_unsafe_view", "_reshape_alias", "scalar_tensor",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
    "_local_scalar_dense", "wait_tensor", "set", "resize", "record_stream",
}


def _name(func) -> str:
    """The op's packet name, in-place variants named as their function
    (``add_`` as ``add``); collectives keep their own names."""
    name = func.overloadpacket.__name__
    if func.namespace in _COLLECTIVE_NAMESPACES:
        return name
    return name[:-1] if name.endswith("_") and not name.endswith("__") else name


class _NotMeta(Exception):
    """An op whose outputs are not all on the ``meta`` device."""


def _signature(x, meta: list):
    """What a meta kernel's outputs depend on: each tensor's device, shape,
    strides and dtype, every other value with its type (1, 1.0 and True
    differ).  Appends to ``meta`` for each meta tensor or device; a tensor
    on another device may only be a 0-dim one (a CPU scalar)."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "meta":
            meta.append(True)
        elif x.dim():
            raise _NotMeta
        return (x.device, x.shape, x.stride(), x.dtype)
    if isinstance(x, (tuple, list)):
        return tuple(_signature(y, meta) for y in x)
    if isinstance(x, dict):
        return tuple((k, _signature(v, meta)) for k, v in sorted(x.items()))
    if isinstance(x, torch.device):
        if x.type != "meta":
            raise _NotMeta
        meta.append(True)
    return (type(x), x)


def _makes_fresh(func, kind: str) -> bool:
    """Whether ``func`` returns new tensors only, none aliasing an input,
    and mutates nothing (``_unsafe_view`` aliases without saying so)."""
    schema = func._schema
    if kind in ("view", "free", "collective") or schema.is_mutable or not schema.returns:
        return False
    return all(r.alias_info is None and isinstance(r.type, torch.TensorType)
               for r in schema.returns)


def _footprint(t: torch.Tensor) -> int:
    """Bytes of ``t`` read once: its elements, a stride-0 (broadcast)
    dimension counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def storages(tree) -> Dict[int, int]:
    """The storages of the tensors in ``tree`` (id -> bytes), each once."""
    return {id(t.untyped_storage()): t.untyped_storage().nbytes() for t in _tensors(tree)}


def _tensors(tree) -> List[torch.Tensor]:
    """The tensors in nested tuples, lists and dicts (an op's arguments and
    results, a step's inputs)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


@dataclasses.dataclass
class Costs:
    """What :func:`count` saw.  Flops, bytes, transcendentals, ops and the
    collectives are weighted (:meth:`add` multiplies them); the memory
    fields are of the one run.  ``result`` is the function's return value."""

    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    ops: float = 0.0
    collective_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_counts: Dict[str, float] = dataclasses.field(default_factory=dict)
    # (kind, bytes, group size, executions, op) per distinct site
    collective_sites: Dict[Tuple[str, int, int, str], float] = dataclasses.field(
        default_factory=dict)
    # op name -> [executions, flops, bytes]
    by_op: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    peak_bytes: int = 0
    result: Any = dataclasses.field(default=None, repr=False, compare=False)
    # the used arguments' storages (id -> bytes), while the caller holds them
    arguments_used: Dict[int, int] = dataclasses.field(default_factory=dict, repr=False,
                                                       compare=False)

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - self.argument_bytes

    def add(self, other: "Costs", mult: float = 1.0) -> None:
        """Add ``other``'s weighted counts, times ``mult`` (not its memory)."""
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        self.transcendentals += other.transcendentals * mult
        self.ops += other.ops * mult
        for mine, theirs in ((self.collective_bytes, other.collective_bytes),
                             (self.collective_counts, other.collective_counts),
                             (self.collective_sites, other.collective_sites)):
            for k, v in theirs.items():
                mine[k] = mine.get(k, 0.0) + v * mult
        for k, (n, f, b) in other.by_op.items():
            row = self.by_op.setdefault(k, [0.0, 0.0, 0.0])
            row[0] += n * mult
            row[1] += f * mult
            row[2] += b * mult


def _group_size(func, args, kwargs) -> int:
    """The process group's size, where a collective's arguments give it
    (``group_size``, ``group_name`` or a ``process_group``)."""
    values = dict(zip((a.name for a in func._schema.arguments), args), **kwargs)
    if "group_size" in values:
        return int(values["group_size"])
    if "group_name" in values:
        from torch.distributed.distributed_c10d import _resolve_process_group
        return int(_resolve_process_group(values["group_name"]).size())
    group = values.get("process_group")
    if group is None:
        return 1
    if isinstance(group, torch.ScriptObject):
        from torch.distributed import ProcessGroup
        group = ProcessGroup.unbox(group)
    return int(group.size())


class _Counter(TorchDispatchMode):
    """Counts every aten op dispatched while it is active, and tracks the
    bytes alive by storage."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self._alive: Dict[int, int] = {}
        self._live = 0
        self.arguments: Dict[int, int] = {}  # storage id -> bytes
        self.read = set()                   # the arguments' storages an op read
        self._rules: Dict[Any, Tuple[str, str, bool]] = {}
        self._fresh: Dict[Any, Tuple[list, bool]] = {}  # signature -> output specs

    # -- memory -------------------------------------------------------------
    def track(self, t: torch.Tensor) -> None:
        """Counts ``t``'s storage as alive from now until it is freed."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._alive:
            return
        n = st.nbytes()
        self._alive[key] = n
        self._live += n
        weakref.finalize(st, self._free, key)
        if self._live > self.costs.peak_bytes:
            self.costs.peak_bytes = self._live

    def _free(self, key: int) -> None:
        self._live -= self._alive.pop(key, 0)

    # -- costs --------------------------------------------------------------
    def _rule(self, func) -> Tuple[str, str, bool]:
        """(kind, name, whether it makes fresh tensors only)."""
        rule = self._rules.get(func)
        if rule is None:
            name = _name(func)
            if func.namespace in _COLLECTIVE_NAMESPACES and name in COLLECTIVE_KINDS:
                kind = "collective"
            elif func.is_view:
                kind = "view"
            elif name in _FREE:
                kind = "free"
            elif name in _DOT:
                kind = "dot"
            elif name == "convolution":
                kind = "conv"
            elif name == "convolution_backward":
                kind = "conv_backward"
            elif name in ("max", "min") and func._overloadname in ("other", "out"):
                kind = "elementwise"  # the binary overloads
            elif name in _REDUCTION:
                kind = "reduction"
            elif name in _ELEMENTWISE:
                kind = "elementwise"
            else:
                kind = "bytes"
            rule = self._rules[func] = (kind, name, _makes_fresh(func, kind))
        return rule

    def _run(self, func, args, kwargs):
        """``func(*args, **kwargs)``; on the ``meta`` device an op that makes
        fresh outputs is run once a signature (its arguments' shapes,
        strides, dtypes and other values) and then gives empty outputs of
        the shapes and strides it gave: most meta kernels are Python, and a
        step repeats its signatures thousands of times."""
        key = None
        if self._rules[func][2]:
            meta = []
            try:
                key = (func, _signature(args, meta), _signature(kwargs, meta))
                hash(key)
                if not meta:
                    raise _NotMeta
            except (_NotMeta, TypeError):
                key = None
        if key is not None and key in self._fresh:
            specs, single = self._fresh[key]
            outs = [torch.empty_strided(size, stride, dtype=dtype, device="meta")
                    for size, stride, dtype in specs]
            return outs[0] if single else tuple(outs)
        out = func(*args, **kwargs)
        if key is not None:
            single = isinstance(out, torch.Tensor)
            outs = [out] if single else out
            self._fresh[key] = ([(t.shape, t.stride(), t.dtype) for t in outs], single)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kind, name, _ = self._rule(func)
        out = self._run(func, args, kwargs)
        if kind == "view":
            return out
        outs = _tensors(out)
        for t in outs:
            self.track(t)
        if kind == "free":  # no cost, but ``empty`` makes a storage
            return out
        ins = _tensors(args) + _tensors(kwargs)
        for t in ins:
            key = id(t.untyped_storage())
            if key in self.arguments:
                self.read.add(key)
        c = self.costs
        nbytes = sum(_footprint(t) for t in ins) + sum(_footprint(t) for t in outs)
        res = sum(t.numel() for t in outs)
        flops = 0.0
        if kind == "collective":
            b = sum(t.numel() * t.element_size() for t in outs) or \
                sum(t.numel() * t.element_size() for t in ins)
            kname = COLLECTIVE_KINDS[name]
            c.collective_bytes[kname] = c.collective_bytes.get(kname, 0.0) + b
            c.collective_counts[kname] = c.collective_counts.get(kname, 0.0) + 1
            site = (kname, b, _group_size(func, args, kwargs), f"{func.namespace}.{name}")
            c.collective_sites[site] = c.collective_sites.get(site, 0.0) + 1
        elif kind == "dot":
            flops = 2.0 * res * self._contraction(name, args)
        elif kind == "conv":
            w = args[1]
            flops = 2.0 * res * math.prod(w.shape[1:]) if not args[6] else \
                2.0 * args[0].numel() * math.prod(w.shape[1:])
        elif kind == "conv_backward":
            grad_out, w, mask = args[0], args[2], args[-1]
            flops = 2.0 * grad_out.numel() * math.prod(w.shape[1:]) * sum(bool(m) for m in mask[:2])
        elif kind == "reduction":
            flops = float(ins[0].numel()) if ins else 0.0
            if name in _SOFTMAX:
                c.transcendentals += flops
        elif kind == "elementwise":
            flops = float(res)
            if name in _TRANSCENDENTAL:
                c.transcendentals += flops
        c.flops += flops
        c.bytes += nbytes
        c.ops += 1
        row = c.by_op.setdefault(name, [0.0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        return out

    @staticmethod
    def _contraction(name: str, args) -> int:
        """K of a dot: the contracted length (times the batch for
        ``addbmm``, which sums the products of its batch)."""
        if name in ("addmm", "baddbmm", "addmv"):
            return args[1].shape[-1]
        if name == "addbmm":
            return args[1].shape[0] * args[1].shape[-1]
        return args[0].shape[-1]


def count(fn, *args, weight: float = 1, **kw) -> Costs:
    """Run ``fn(*args, **kw)`` under the counting mode and return what it
    dispatched, its counts multiplied by ``weight``, with its memory (see the
    module docstring) and its return value as ``result``.  Arguments that no
    op reads count in no memory field, as ``jax.jit`` drops unused
    arguments (one returned as it is counts).  A count does not nest in
    another."""
    mode = _Counter()
    mode.arguments = storages((args, kw))
    for t in _tensors((args, kw)):
        mode.track(t)
    with mode:
        result = fn(*args, **kw)
    out_keys = storages(result)
    used = {k: n for k, n in mode.arguments.items() if k in mode.read or k in out_keys}
    unread = sum(mode.arguments.values()) - sum(used.values())
    costs = Costs(result=result, argument_bytes=sum(used.values()),
                  output_bytes=sum(out_keys.values()),
                  alias_bytes=sum(n for k, n in out_keys.items() if k in used),
                  peak_bytes=mode.costs.peak_bytes - unread, arguments_used=used)
    costs.add(mode.costs, weight)
    return costs


def summarize(costs: Costs) -> Dict:
    """``hloparse.summarize``'s keys, plus ``ops`` and ``top`` (the
    ``TOP_OPS`` heaviest aten ops by flops and by bytes: executions, flops,
    bytes)."""
    def heaviest(col: int):
        rows = sorted(costs.by_op.items(), key=lambda kv: -kv[1][col])[:TOP_OPS]
        return [{"op": k, "count": n, "flops": f, "bytes": b} for k, (n, f, b) in rows
                if (f, b)[col - 1] > 0]

    return {
        "flops": costs.flops,
        "bytes": costs.bytes,
        "transcendentals": costs.transcendentals,
        "collective_bytes": dict(costs.collective_bytes),
        "collective_counts": dict(costs.collective_counts),
        "collective_sites": [
            {"kind": k, "bytes": b, "group": g, "mult": m, "op": op}
            for (k, b, g, op), m in sorted(costs.collective_sites.items(),
                                           key=lambda s: -s[0][1] * s[1])[:64]
        ],
        "ops": costs.ops,
        "top": {"flops": heaviest(1), "bytes": heaviest(2)},
    }
