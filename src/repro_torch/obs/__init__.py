"""Engine-wide telemetry of the port.

Port copy of ``repro.obs`` (the port imports nothing of the reference, so
it keeps its own registry; the metric names, kinds and exposition text are
the reference's, so one scraper reads both packages):

* :mod:`repro_torch.obs.metrics` — labeled counter/gauge/histogram registry
  with cheap thread-safe increments, ``snapshot()``, and Prometheus text
  exposition; global kill switch ``REPRO_OBS=off``.
* :mod:`repro_torch.obs.tracing` — :class:`TraceRing`, the bounded event
  log behind the ONLINE-UNION φ-trajectory tracer.
* :mod:`repro_torch.obs.http` — :class:`MetricsServer`, the background HTTP
  thread serving ``/metrics`` (Prometheus text) and ``/healthz``.

Instrumented layers: the union engine folds its per-piece round counters,
rounds and samples into the registry at its one fetch per ``sample(n)``,
ONLINE-UNION appends φ-refresh/backtrack events to its trace ring and
publishes its refresh counters, and the serve tier records request-latency
histograms, queue depth, and per-replica ``SamplerStats``.  All of it is on
by default and disabled end-to-end by ``REPRO_OBS=off`` (samples are
bit-identical either way — the switch only gates host-side timers and
registry publication).
"""

from .http import MetricsServer, PROMETHEUS_CONTENT_TYPE
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_latency_buckets, enabled, get_registry,
                      set_enabled, set_registry, trace_annotations_enabled)
from .tracing import TraceRing

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MetricsServer",
    "PROMETHEUS_CONTENT_TYPE", "TraceRing", "default_latency_buckets",
    "enabled", "fallback_events", "get_registry", "record_fallback",
    "set_enabled", "set_registry", "trace_annotations_enabled",
]

# ---------------------------------------------------------------------------
# Engine fallback telemetry: every point where a device path degrades to a
# slower one increments repro_engine_fallback_total{reason=...} and appends
# a TraceRing event.  The port's engines raise instead of degrading, so
# nothing of the port records one yet; the series keeps the reference's name
# for a caller that does.
# ---------------------------------------------------------------------------

_fallback_trace = TraceRing(capacity=256)

_FALLBACK_HELP = ("Times a fused/device engine path degraded to the host "
                  "engine, by reason")


def record_fallback(reason: str, detail: str = "", join: str = "") -> None:
    """Record one engine degrade event.

    ``reason`` is the stable low-cardinality label; ``detail``/``join`` carry
    the free-form context into the trace ring only.
    """
    if not enabled():
        return
    get_registry().counter("repro_engine_fallback_total", _FALLBACK_HELP,
                           ("reason",)).labels(reason=reason).inc()
    _fallback_trace.append("engine_fallback", reason=reason, detail=detail,
                           join=join)


def fallback_events():
    """The recent engine-fallback events (newest last)."""
    return _fallback_trace.events()
