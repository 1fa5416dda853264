"""repro_torch.obs — wait-free telemetry: metrics, spans and probe health.

Port of ``repro.obs`` (its own copy: the port imports nothing of
``repro``).  Two halves:

* :mod:`repro_torch.obs.metrics` — a thread-safe registry of counters,
  gauges, exact integer histograms, float samples, spans (host wall time)
  and bounded structured events, plus the no-op twin every code path holds
  when observability is off.  Enable via ``WaitFreeGraph(obs=...)``,
  ``ServingEngine(obs=...)`` or the ``REPRO_OBS`` environment variable.
* :mod:`repro_torch.obs.probes` — probe-chain health derived after the fact
  from the hash tables (physical per-table histograms, and the
  shard-count-invariant histogram of the canonical vertex directory).

**Overhead contract:** every metric is derived from tensors the engine
passes compute anyway, read to the host only when a registry is enabled
(at most one read of a pass's stats vector), so obs-on and obs-off runs
give byte-identical tables and answers.  Disabled, every recording call is
a method of the shared no-op registry: no locks, no writes, no device
synchronisation.  Metric names and the ``dump()`` schema are those of
``docs/OBSERVABILITY.md``.
"""

from .metrics import (
    NOOP,
    NoopRegistry,
    Registry,
    active,
    counter,
    event,
    fastpath_frac,
    from_env,
    gauge,
    hist,
    observe,
    resolve,
    span,
    use,
)

__all__ = [
    "Registry",
    "NoopRegistry",
    "NOOP",
    "active",
    "use",
    "resolve",
    "from_env",
    "counter",
    "gauge",
    "hist",
    "observe",
    "event",
    "span",
    "fastpath_frac",
]
