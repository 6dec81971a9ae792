"""Metrics core: a labeled registry of counters / gauges / histograms.

Port copy of ``repro.obs.metrics`` (the port imports nothing of the
reference): the same metric names, kinds and exposition text, so one
scraper reads both packages.  Design constraints, in order:

1. **Cheap increments.**  Instrumentation sits on the serve request path and
   at the engine's once-per-``sample(n)`` host sync — an increment is one
   lock acquire plus a float add.  Anything heavier (rendering, quantile
   estimation, label resolution) happens at scrape/snapshot time.
2. **Thread-safe.**  The serve tier increments from producer threads and
   concurrent ``request()`` callers; every metric child guards its state
   with its own lock, and the registry guards its tables.
3. **Prometheus text exposition.**  :meth:`MetricsRegistry.render` emits the
   text format (version 0.0.4) that ``/metrics`` serves — counters with a
   ``_total`` convention left to the caller, histograms as cumulative
   ``_bucket{le=...}`` series plus ``_sum``/``_count``.

The global kill switch is the ``REPRO_OBS`` environment variable: set it to
``off`` (or ``0``/``false``/``no``) to disable instrumentation everywhere
(sites check :func:`enabled` before doing host-side work; the registry keeps
functioning so late scrapes never crash).  Tests and benchmarks toggle at
runtime with :func:`set_enabled`; ``set_enabled(None)`` re-reads the
environment.  ``REPRO_OBS_TRACE=1`` (or ``set_tracing(True)``) additionally
turns on the host spans of :mod:`repro_torch.obs.tracing` (off by default).
"""

from __future__ import annotations

import bisect
import math
import os
import re
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "enabled", "set_enabled",
    "default_latency_buckets", "Counter", "Gauge", "Histogram",
    "MetricsRegistry", "get_registry", "set_registry",
]

_OFF_VALUES = ("off", "0", "false", "no")

_enabled_override: Optional[bool] = None
_enabled_lock = threading.Lock()


def _env_enabled() -> bool:
    return os.environ.get("REPRO_OBS", "on").strip().lower() not in _OFF_VALUES


def enabled() -> bool:
    """Is instrumentation on?  (``REPRO_OBS=off`` or ``set_enabled(False)``
    turns it off.)"""
    override = _enabled_override
    if override is not None:
        return override
    return _env_enabled()


def set_enabled(on: Optional[bool]) -> None:
    """Runtime override of the ``REPRO_OBS`` switch; ``None`` restores the
    environment-driven default."""
    global _enabled_override
    with _enabled_lock:
        _enabled_override = on
    from . import tracing           # the spans' switch follows this one
    tracing.refresh()


def default_latency_buckets() -> Tuple[float, ...]:
    """Log-spaced (×2) latency buckets: 10 µs up to ~84 s."""
    return tuple(1e-5 * 2.0 ** k for k in range(24))


_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _escape_label_value(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _format_value(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if isinstance(v, float) and v != v:
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labels_suffix(labels: Tuple[Tuple[str, str], ...],
                   extra: Tuple[Tuple[str, str], ...] = ()) -> str:
    items = labels + extra
    if not items:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(str(v))}"' for k, v in items)
    return "{" + body + "}"


class _Child:
    """One labeled series of a metric (the no-label metric is its own
    single child)."""

    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = threading.Lock()


class _CounterChild(_Child):
    __slots__ = ("value",)

    def __init__(self):
        super().__init__()
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self.value += amount


class _GaugeChild(_Child):
    __slots__ = ("value", "fn")

    def __init__(self):
        super().__init__()
        self.value = 0.0
        self.fn: Optional[Callable[[], float]] = None

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        """Pull-time gauge: ``fn`` is evaluated at snapshot/render (e.g.
        queue depth)."""
        with self._lock:
            self.fn = fn

    def get(self) -> float:
        with self._lock:
            if self.fn is not None:
                try:
                    return float(self.fn())
                except Exception:
                    return float("nan")
            return self.value


class _HistogramChild(_Child):
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Tuple[float, ...]):
        super().__init__()
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # last = +Inf overflow
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (scrape-side convenience;
        Prometheus proper recomputes from the ``_bucket`` series)."""
        with self._lock:
            total = self.count
            counts = list(self.counts)
        if total == 0:
            return 0.0
        target = q * total
        cum = 0.0
        lo = 0.0
        for i, c in enumerate(counts):
            hi = self.bounds[i] if i < len(self.bounds) else lo
            if cum + c >= target and c > 0:
                frac = (target - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
            lo = hi
        return lo


class _Metric:
    """Base labeled metric: a family of children keyed by label values."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], _Child] = {}
        if not self.labelnames:
            self._children[()] = self._new_child()

    def _new_child(self) -> _Child:
        raise NotImplementedError

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass label values positionally or by "
                                 "keyword, not both")
            try:
                values = tuple(kv[ln] for ln in self.labelnames)
            except KeyError as e:
                raise ValueError(f"missing label {e} for {self.name}") from e
            if len(kv) != len(self.labelnames):
                raise ValueError(f"unexpected labels for {self.name}: "
                                 f"{sorted(set(kv) - set(self.labelnames))}")
        key = tuple(str(v) for v in values)
        if len(key) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got {key}")
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def _default(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled {self.labelnames}; "
                             "use .labels(...)")
        return self._children[()]

    def _series(self) -> List[Tuple[Tuple[Tuple[str, str], ...], _Child]]:
        with self._lock:
            items = list(self._children.items())
        return [(tuple(zip(self.labelnames, key)), child)
                for key, child in sorted(items)]


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def snapshot(self) -> Dict[Tuple[Tuple[str, str], ...], float]:
        return {lk: c.value for lk, c in self._series()}

    def render(self, out: List[str]) -> None:
        for lk, c in self._series():
            out.append(f"{self.name}{_labels_suffix(lk)} "
                       f"{_format_value(c.value)}")


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._default().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._default().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._default().dec(amount)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._default().set_function(fn)

    def get(self) -> float:
        return self._default().get()

    def snapshot(self) -> Dict[Tuple[Tuple[str, str], ...], float]:
        return {lk: c.get() for lk, c in self._series()}

    def render(self, out: List[str]) -> None:
        for lk, c in self._series():
            out.append(f"{self.name}{_labels_suffix(lk)} "
                       f"{_format_value(c.get())}")


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = (),
                 buckets: Optional[Iterable[float]] = None):
        bounds = tuple(sorted(buckets)) if buckets is not None \
            else default_latency_buckets()
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = bounds
        super().__init__(name, help, labelnames)

    def _new_child(self):
        return _HistogramChild(self.bounds)

    def observe(self, value: float) -> None:
        self._default().observe(value)

    def quantile(self, q: float) -> float:
        return self._default().quantile(q)

    def snapshot(self) -> Dict[Tuple[Tuple[str, str], ...], Dict]:
        out = {}
        for lk, c in self._series():
            with c._lock:
                out[lk] = {"buckets": dict(zip(self.bounds, c.counts)),
                           "overflow": c.counts[-1],
                           "sum": c.sum, "count": c.count}
        return out

    def render(self, out: List[str]) -> None:
        for lk, c in self._series():
            with c._lock:
                counts = list(c.counts)
                total, s = c.count, c.sum
            cum = 0
            for bound, n in zip(self.bounds, counts):
                cum += n
                out.append(
                    f"{self.name}_bucket"
                    f"{_labels_suffix(lk, (('le', _format_value(bound)),))}"
                    f" {cum}")
            out.append(f"{self.name}_bucket"
                       f"{_labels_suffix(lk, (('le', '+Inf'),))} {total}")
            out.append(f"{self.name}_sum{_labels_suffix(lk)} "
                       f"{_format_value(s)}")
            out.append(f"{self.name}_count{_labels_suffix(lk)} {total}")


class MetricsRegistry:
    """Get-or-create metric registry with snapshot + Prometheus rendering.

    ``collectors`` are pull-time hooks (e.g. the serve tier refreshing its
    queue-depth and quantile gauges) run at the top of every
    :meth:`snapshot`/:meth:`render`; a collector that raises is dropped from
    the scrape, never propagated into it.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._collectors: List[Callable[[], None]] = []

    def _get_or_create(self, cls, name: str, help: str,
                       labelnames: Sequence[str], **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, labelnames, **kw)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} with "
                f"labels {m.labelnames}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        m = self._get_or_create(Histogram, name, help, labelnames,
                                buckets=buckets)
        return m

    def add_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            self._collectors.append(fn)

    def remove_collector(self, fn: Callable[[], None]) -> None:
        with self._lock:
            if fn in self._collectors:
                self._collectors.remove(fn)

    def _run_collectors(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:
                pass

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def snapshot(self) -> Dict[str, Dict]:
        """Point-in-time copy of every series, keyed by metric name."""
        self._run_collectors()
        with self._lock:
            metrics = list(self._metrics.values())
        return {m.name: {"type": m.kind, "help": m.help,
                         "series": m.snapshot()} for m in metrics}

    def render(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        self._run_collectors()
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        out: List[str] = []
        for m in metrics:
            if m.help:
                out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            m.render(out)
        return "\n".join(out) + "\n"

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()
            self._collectors.clear()


_registry = MetricsRegistry()
_registry_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global default registry (what ``/metrics`` serves)."""
    return _registry


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    """Swap the global registry (tests); returns the previous one."""
    global _registry
    with _registry_lock:
        prev, _registry = _registry, reg
    return prev
