"""Thread-safe metrics registry + no-op twin + active-registry context.

Copy of ``repro.obs.metrics`` (stdlib only), with the same API, the same
``repro-obs/1`` dump schema and the same ``REPRO_OBS`` switch:

* **Derived, never intrusive** — recorders take values the engine passes
  already computed (stats vectors, mask sums, level maps), reduced on the
  host and passed as plain ints/floats.  Nothing in this module touches a
  tensor, so obs-on and obs-off runs compute the same tables
  (``tests/test_torch_obs.py``).
* **Zero-cost off switch** — disabled code paths hold :data:`NOOP`, whose
  methods are empty and whose ``span`` returns one shared null context
  manager.
* **Exact integer histograms** — claim rounds, probe lengths, queue depths
  and frontier depths are small ints, stored as exact per-value counts, so
  tests compare histograms across shard counts with ``==``.
* **Ambient access** — module-level code (host claim rounds, the delta
  fold's decisions) records through the thread-local *active* registry
  installed by :func:`use`; ``WaitFreeGraph`` wraps every public entry point
  in ``use(self.obs)``.

A span is host wall time (``time.perf_counter``).  On the card, work is
queued asynchronously and a span adds no synchronisation, so a span holds
device time only where the code inside it already waits for the device
(a read back to the host).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Union

_MAX_EVENTS = 1024  # bounded event log: growth/rehash escalations are rare

_TRUTHY = ("1", "true", "on", "yes")


def _summary_ms(samples: List[float]) -> Dict[str, float]:
    """count/total/mean/p50/p99/max over a duration list, in milliseconds."""
    n = len(samples)
    s = sorted(samples)
    total = sum(s)
    return {
        "count": n,
        "total_ms": 1e3 * total,
        "mean_ms": 1e3 * total / n,
        "p50_ms": 1e3 * s[n // 2],
        "p99_ms": 1e3 * s[min(n - 1, (99 * n) // 100)],
        "max_ms": 1e3 * s[-1],
    }


def _hist_summary(counts: Dict[int, int]) -> Dict[str, object]:
    values = sorted(counts)
    n = sum(counts.values())
    total = sum(v * c for v, c in counts.items())
    out = {
        "count": n,
        "total": total,
        "mean": total / n,
        "min": values[0],
        "max": values[-1],
        "p50": _percentile_from_counts(counts, 50.0),
        "p99": _percentile_from_counts(counts, 99.0),
        "counts": {str(v): counts[v] for v in values},
    }
    return out


def _percentile_from_counts(counts: Dict[int, int], q: float) -> int:
    n = sum(counts.values())
    rank = min(n - 1, int((q / 100.0) * n))
    seen = 0
    for v in sorted(counts):
        seen += counts[v]
        if seen > rank:
            return v
    return max(counts)  # unreachable for well-formed counts


class _Span:
    """Context manager timing one named section into a registry."""

    __slots__ = ("_reg", "_name", "_t0")

    def __init__(self, reg: "Registry", name: str):
        self._reg = reg
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._reg._record_span(self._name, time.perf_counter() - self._t0)
        return False


class Registry:
    """Thread-safe store of counters, gauges, histograms, samples, spans,
    and bounded events.  One registry per observed run (a graph, a serving
    engine, a benchmark build); :meth:`dump` snapshots it as JSON-ready
    plain data."""

    enabled = True

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}
        self._hists: Dict[str, Dict[int, int]] = {}
        self._samples: Dict[str, List[float]] = {}
        self._spans: Dict[str, List[float]] = {}
        self._events: List[Dict] = []
        self._dropped_events = 0

    # -- recorders ---------------------------------------------------------
    def counter(self, name: str, n: Union[int, float] = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(n)

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def hist(self, name: str, values: Union[int, Iterable[int]]) -> None:
        """Record exact integer observation(s) into a named histogram."""
        if not isinstance(values, Iterable):
            values = (values,)
        with self._lock:
            h = self._hists.setdefault(name, {})
            for v in values:
                v = int(v)
                h[v] = h.get(v, 0) + 1

    def observe(self, name: str, value: float) -> None:
        """Record one float sample (e.g. a latency in ms) for percentiles."""
        with self._lock:
            self._samples.setdefault(name, []).append(float(value))

    def event(self, name: str, **fields) -> None:
        """Append one structured event (growth, rehash escalation, ...)."""
        with self._lock:
            if len(self._events) >= _MAX_EVENTS:
                self._dropped_events += 1
                return
            self._events.append({"event": name, **fields})

    def span(self, name: str) -> _Span:
        """``with reg.span("phase.route"): ...`` — wall-clock section timer."""
        return _Span(self, name)

    def _record_span(self, name: str, seconds: float) -> None:
        with self._lock:
            self._spans.setdefault(name, []).append(seconds)

    # -- readers -----------------------------------------------------------
    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def hist_counts(self, name: str) -> Dict[int, int]:
        with self._lock:
            return dict(self._hists.get(name, {}))

    def percentile(self, name: str, q: float) -> Optional[float]:
        """q-th percentile of a histogram (exact) or sample series, or
        ``None`` when the name has no observations."""
        with self._lock:
            h = self._hists.get(name)
            if h:
                return float(_percentile_from_counts(dict(h), q))
            s = self._samples.get(name)
            if s:
                ss = sorted(s)
                return ss[min(len(ss) - 1, int((q / 100.0) * len(ss)))]
        return None

    def dump(self) -> Dict:
        """Structured JSON-ready snapshot (schema: ``docs/OBSERVABILITY.md``)."""
        with self._lock:
            out = {
                "schema": "repro-obs/1",
                "counters": dict(sorted(self._counters.items())),
                "gauges": dict(sorted(self._gauges.items())),
                "histograms": {
                    k: _hist_summary(v)
                    for k, v in sorted(self._hists.items())
                    if v
                },
                "samples": {
                    k: _summary_ms([x / 1e3 for x in v])  # values already ms
                    for k, v in sorted(self._samples.items())
                    if v
                },
                "spans": {
                    k: _summary_ms(v) for k, v in sorted(self._spans.items()) if v
                },
                "events": list(self._events),
            }
            if self._dropped_events:
                out["dropped_events"] = self._dropped_events
            return out


class NoopRegistry:
    """API twin of :class:`Registry` with empty bodies — what every
    instrumented path holds when observability is disabled."""

    enabled = False
    _NULL = contextlib.nullcontext()

    def counter(self, name, n=1):
        pass

    def gauge(self, name, value):
        pass

    def hist(self, name, values):
        pass

    def observe(self, name, value):
        pass

    def event(self, name, **fields):
        pass

    def span(self, name):
        return self._NULL

    def counters(self):
        return {}

    def hist_counts(self, name):
        return {}

    def percentile(self, name, q):
        return None

    def dump(self):
        return {"schema": "repro-obs/1", "enabled": False}


NOOP = NoopRegistry()


def from_env() -> Union[Registry, NoopRegistry]:
    """A fresh :class:`Registry` when ``REPRO_OBS`` is truthy, else NOOP."""
    if os.environ.get("REPRO_OBS", "").strip().lower() in _TRUTHY:
        return Registry()
    return NOOP


def resolve(obs) -> Union[Registry, NoopRegistry]:
    """Normalize the ``obs=`` constructor flag: ``None`` defers to the
    ``REPRO_OBS`` env var, ``True``/``False`` force a fresh registry / the
    no-op, and a registry instance is used as-is (sharing one registry
    across graphs aggregates their metrics)."""
    if obs is None:
        return from_env()
    if obs is True:
        return Registry()
    if obs is False:
        return NOOP
    return obs


# ---------------------------------------------------------------------------
# thread-local active registry: ambient recording for module-level code
# ---------------------------------------------------------------------------

_tls = threading.local()


def active() -> Union[Registry, NoopRegistry]:
    """The innermost registry installed by :func:`use` on this thread
    (NOOP outside any ``use`` block)."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else NOOP


@contextlib.contextmanager
def use(reg):
    """Install ``reg`` as the thread's active registry for the block —
    how ``WaitFreeGraph`` hands its registry to maintenance/traversal code
    without threading a parameter through every signature."""
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(reg if reg is not None else NOOP)
    try:
        yield stack[-1]
    finally:
        stack.pop()


# module-level recorder shorthands against the active registry
def counter(name: str, n: Union[int, float] = 1) -> None:
    active().counter(name, n)


def gauge(name: str, value: float) -> None:
    active().gauge(name, value)


def hist(name: str, values) -> None:
    active().hist(name, values)


def observe(name: str, value: float) -> None:
    active().observe(name, value)


def event(name: str, **fields) -> None:
    active().event(name, **fields)


def span(name: str):
    return active().span(name)


# ---------------------------------------------------------------------------
# derived summaries
# ---------------------------------------------------------------------------


def fastpath_frac(reg) -> Optional[float]:
    """Fraction of FPSP ops resolved on the fast (sort-free) lane.

    1-shard FPSP graphs record the full conflict mask
    (``fastpath.conflicted`` / ``fastpath.ops``); partitioned graphs record
    the shard-invariant edge-lane split (``fastpath.edge_dup`` /
    ``fastpath.eops`` — duplicate ``(u, v)`` keys always co-locate on one
    shard, so the summed counters match any shard count).  Returns ``None``
    when the registry saw no FPSP traffic."""
    c = reg.counters()
    ops = c.get("fastpath.ops", 0)
    if ops:
        return 1.0 - c.get("fastpath.conflicted", 0) / ops
    eops = c.get("fastpath.eops", 0)
    if eops:
        return 1.0 - c.get("fastpath.edge_dup", 0) / eops
    return None
