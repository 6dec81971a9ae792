"""Observability of the port: the φ-trajectory tracer.

Port copy of ``repro.obs.tracing.TraceRing``.  The reference's metrics
registry and its counters are not ported yet."""

from .tracing import TraceRing

__all__ = ["TraceRing"]
