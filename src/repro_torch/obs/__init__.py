"""Engine-wide telemetry of the port.

Port copy of ``repro.obs`` (the port imports nothing of the reference, so
it keeps its own registry; the metric names, kinds and exposition text are
the reference's, so one scraper reads both packages):

* :mod:`repro_torch.obs.metrics` — labeled counter/gauge/histogram registry
  with cheap thread-safe increments, ``snapshot()``, and Prometheus text
  exposition; global kill switch ``REPRO_OBS=off``.
* :mod:`repro_torch.obs.tracing` — :class:`TraceRing`, the bounded event
  log behind the ONLINE-UNION φ-trajectory tracer, and :func:`span`, the
  host spans of the serve tier and the round loop (``REPRO_OBS_TRACE=1`` or
  :func:`set_tracing`; per-name totals in :func:`span_totals`, each span a
  ``torch.profiler`` range while a profiler session is active).
* :mod:`repro_torch.obs.http` — :class:`MetricsServer`, the background HTTP
  thread serving ``/metrics`` (Prometheus text) and ``/healthz``.

Instrumented layers: the union engine folds its per-piece round counters,
rounds and samples into the registry at its one fetch per ``sample(n)``,
ONLINE-UNION appends φ-refresh/backtrack events to its trace ring and
publishes its refresh counters, and the serve tier records request-latency
histograms, queue depth, and per-replica ``SamplerStats``.  All of it is on
by default and disabled end-to-end by ``REPRO_OBS=off`` (samples are
bit-identical either way — the switch only gates host-side timers and
registry publication).  The host spans, and the device loop's CUDA-event
timing of each chunk (the engine's ``graph_device_seconds``), are off unless
``REPRO_OBS_TRACE=1`` or ``set_tracing(True)``.
"""

from .http import MetricsServer, PROMETHEUS_CONTENT_TYPE
from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      default_latency_buckets, enabled, get_registry,
                      set_enabled, set_registry)
from .tracing import (TraceRing, set_tracing, span, span_totals,
                      trace_annotations_enabled, trace_time_ns)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "MetricsServer",
    "PROMETHEUS_CONTENT_TYPE", "TraceRing", "default_latency_buckets",
    "enabled", "fallback_events", "get_registry", "record_fallback",
    "set_enabled", "set_registry", "set_tracing", "span", "span_totals",
    "trace_annotations_enabled", "trace_time_ns",
]

# ---------------------------------------------------------------------------
# Engine fallback telemetry: every point where a device path degrades to a
# slower one increments repro_engine_fallback_total{reason=...} and appends
# a TraceRing event, under the reference's series name.  The port records
# one where a join leaves the int32 domain (host draws), where membership
# falls back to the host oracle, where a predicate or the strict paper loop
# sends the union to the host engine, and where online refinement walks run
# on numpy (torch_backend.py, union_sampler.py, online.py); a join method
# the device lacks is recorded before it raises.
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
