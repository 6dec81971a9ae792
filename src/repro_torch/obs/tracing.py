"""Bounded ring-buffer event log — the φ-trajectory tracer — and the
program's host spans.

:class:`TraceRing` is the port copy of ``repro.obs.tracing``.

ONLINE-UNION's whole pitch is refining cheap initial parameter estimates on
the fly; :class:`TraceRing` makes that refinement observable.  The sampler
appends one event dict per notable transition (init, φ-refresh, backtrack)
and the ring keeps the last ``capacity`` of them with a monotone sequence
number, so a long-running service holds bounded memory while the bench CLIs
and tests can dump the recent trajectory.

Events are plain dicts (JSON-friendly); the ring stamps ``seq`` and ``kind``
and never mutates caller payloads.  Appends are thread-safe (the serve tier
may refine φ from a producer thread while a scraper drains the ring).

:func:`span` times a named stretch of host work where it happens (the serve
tier's request path and producer, the engine's round loop and drain).  The
switch is ``REPRO_OBS_TRACE=1`` or :func:`set_tracing`, and the
``REPRO_OBS`` kill switch turns it off with everything else; the
environment is read at import and at each ``set_tracing``/``set_enabled``
call.  Off, a span site costs one read of a module flag and returns a
shared no-op context.  On, each span reads the wall clock
(``perf_counter_ns``) and the thread's CPU clock (``thread_time_ns``) at
entry and exit and adds wall ns, CPU ns and one count to a per-name total
(:func:`span_totals`); spans nest and come from any thread.  A span still
open when the totals are read adds what it has run so far, so the change
of the totals between two reads is the span time that fell between them
(a producer parked across a reader's pause is not put down to the
stretch after it).  While a ``torch.profiler`` session is active each span
also opens a ``record_function`` range of its name, so the trace carries
it, and :func:`trace_time_ns` maps a ``perf_counter_ns`` reading onto the
profiler's clock (kineto stamps host events in Unix-epoch ns).
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

from .metrics import enabled

__all__ = ["TraceRing", "set_tracing", "span", "span_totals",
           "trace_annotations_enabled", "trace_time_ns"]


class TraceRing:
    """Fixed-capacity event log with monotone sequence numbers."""

    def __init__(self, capacity: int = 256):
        if capacity <= 0:
            raise ValueError("TraceRing capacity must be positive")
        self.capacity = int(capacity)
        self._buf: List[Optional[Dict]] = [None] * self.capacity
        self._seq = 0                       # total events ever appended
        self._lock = threading.Lock()

    def append(self, kind: str, **fields) -> Dict:
        """Record one event; returns the stored dict (with ``seq`` set)."""
        ev = {"seq": None, "kind": str(kind), **fields}
        with self._lock:
            ev["seq"] = self._seq
            self._buf[self._seq % self.capacity] = ev
            self._seq += 1
        return ev

    def events(self, kind: Optional[str] = None) -> List[Dict]:
        """Buffered events, oldest first; optionally filtered by kind."""
        with self._lock:
            n = min(self._seq, self.capacity)
            start = self._seq - n
            out = [dict(self._buf[i % self.capacity])
                   for i in range(start, self._seq)]
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        return out

    def last(self, kind: Optional[str] = None) -> Optional[Dict]:
        evs = self.events(kind)
        return evs[-1] if evs else None


# ---------------------------------------------------------------------------
# Host spans
# ---------------------------------------------------------------------------

_on = False                         # the spans' switch, read at every site
_override: Optional[bool] = None    # set_tracing's value; None: environment
_totals: Dict[str, List[int]] = {}  # name -> [wall ns, thread-CPU ns, count]
_open: Dict[int, "_Span"] = {}      # id -> span entered and not yet left
_totals_lock = threading.Lock()
_anchor: Tuple[int, int] = (0, 0)   # (perf_counter_ns, time_ns) read together


def _env_tracing() -> bool:
    return (os.environ.get("REPRO_OBS_TRACE", "").strip().lower()
            in ("1", "on", "true", "yes"))


def _take_anchor(reads: int = 5) -> Tuple[int, int]:
    """A ``(perf_counter_ns, time_ns)`` pair: of a few reads, the one whose
    two ``perf_counter_ns`` reads around ``time_ns`` lie closest."""
    best = None
    for _ in range(reads):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, u)
    return best[1], best[2]


def refresh() -> None:
    """Re-read the switch: ``set_tracing``'s value, else the environment,
    and off while ``REPRO_OBS`` is off.  Switching on re-anchors
    :func:`trace_time_ns`."""
    global _on, _anchor
    on = enabled() and (_override if _override is not None
                        else _env_tracing())
    if on and not _on:
        _anchor = _take_anchor()
    _on = bool(on)


def set_tracing(on: Optional[bool]) -> None:
    """Runtime override of ``REPRO_OBS_TRACE``; ``None`` restores the
    environment-driven default."""
    global _override
    _override = on
    refresh()


def trace_annotations_enabled() -> bool:
    """Are the spans on (``REPRO_OBS_TRACE=1`` or ``set_tracing(True)``,
    and ``REPRO_OBS`` not off)?"""
    return _on


def trace_time_ns(perf_ns: int) -> int:
    """A ``time.perf_counter_ns()`` reading on the profiler's clock
    (Unix-epoch ns), through the pair read when the spans were switched
    on."""
    p0, u0 = _anchor
    return int(perf_ns) - p0 + u0


def _profiler_active() -> bool:
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and bool(getattr(prof, "_is_profiler_enabled",
                                             False))


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "t0", "c0", "tid", "rf")

    def __init__(self, name: str):
        self.name = name
        self.rf = None

    def __enter__(self):
        if _profiler_active():
            import torch
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.tid = threading.get_ident()
        self.t0 = time.perf_counter_ns()
        self.c0 = time.thread_time_ns()
        with _totals_lock:
            _open[id(self)] = self
        return self

    def __exit__(self, *exc):
        c = time.thread_time_ns()
        t = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        with _totals_lock:
            del _open[id(self)]
            tot = _totals.get(self.name)
            if tot is None:
                _totals[self.name] = [t - self.t0, c - self.c0, 1]
            else:
                tot[0] += t - self.t0
                tot[1] += c - self.c0
                tot[2] += 1
        return False


def span(name: str):
    """A context that adds its wall and thread-CPU time to ``name``'s
    total while the spans are on, and does nothing while they are off."""
    if not _on:
        return _NO_SPAN
    return _Span(name)


def _thread_cpu_ns(tid: int) -> Optional[int]:
    try:
        return time.clock_gettime_ns(time.pthread_getcpuclockid(tid))
    except (AttributeError, OSError):
        return None


def span_totals() -> Dict[str, Dict[str, float]]:
    """``{name: {"s": wall seconds, "cpu_s": thread-CPU seconds, "n":
    count}}`` since the process started: every span closed (``n`` counts
    them) and what each open span has run so far."""
    with _totals_lock:
        now = time.perf_counter_ns()
        items = {k: list(v) for k, v in _totals.items()}
        for sp in _open.values():
            tot = items.setdefault(sp.name, [0, 0, 0])
            tot[0] += now - sp.t0
            cpu = _thread_cpu_ns(sp.tid)
            if cpu is not None:
                tot[1] += max(cpu - sp.c0, 0)
    return {k: {"s": w / 1e9, "cpu_s": c / 1e9, "n": n}
            for k, (w, c, n) in items.items()}


_anchor = _take_anchor()
refresh()
