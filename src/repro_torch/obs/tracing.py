"""Bounded ring-buffer event log — the φ-trajectory tracer.

Port copy of ``repro.obs.tracing``.

ONLINE-UNION's whole pitch is refining cheap initial parameter estimates on
the fly; :class:`TraceRing` makes that refinement observable.  The sampler
appends one event dict per notable transition (init, φ-refresh, backtrack)
and the ring keeps the last ``capacity`` of them with a monotone sequence
number, so a long-running service holds bounded memory while the bench CLIs
and tests can dump the recent trajectory.

Events are plain dicts (JSON-friendly); the ring stamps ``seq`` and ``kind``
and never mutates caller payloads.  Appends are thread-safe (the serve tier
may refine φ from a producer thread while a scraper drains the ring).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

__all__ = ["TraceRing"]


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
