"""Streaming union-sample service — the serving front-end over the engines.

:class:`SampleService` turns any union sampler (host, fused device, or
mesh-sharded — anything with ``sample(n) -> SampleSet``) into a streaming
source for serving traffic:

* **prefetched sample queue** — one producer thread per engine keeps a
  bounded queue of fixed-size sample batches warm, so request latency is a
  queue pop, not an engine round.  Because probe-mode samples are i.i.d.
  ``1/|U|`` draws, any contiguous slice of the prefetched stream is itself a
  valid uniform sample — slicing batches across requests is free.
* **request batching** — concurrent ``request(n)`` calls drain the shared
  stream under a cursor lock; the engine only ever runs its own
  (device-optimal) ``batch``-sized rounds regardless of per-request sizes,
  which is exactly what the fused/sharded engines' surplus banking is built
  for.
* **replicas** — pass several engines (e.g. seed-split replicas, one per
  host or per mesh) and their streams interleave into one queue; per-engine
  cost accounting combines with :meth:`SamplerStats.merge`.

* **telemetry** — every ``request()`` lands in the
  ``repro_serve_request_seconds`` latency histogram (p50/p99 gauges derived
  at scrape time), with request/sample counters, a queue-depth /
  prefetch-occupancy gauge, and per-replica ``SamplerStats`` gauges, under
  the reference's names; ``python -m repro_torch.launch.serve --mode
  samples --metrics-port P`` exposes all of it on
  ``http://127.0.0.1:P/metrics`` next to a ``/healthz`` liveness probe.
  ``REPRO_OBS=off`` disables it.

Port copy of ``repro.serve.service``; ``python -m repro_torch.launch.serve
--mode samples`` routes through this class.  The torch engine pins its own
device and CUDA stream inside ``sample_async`` and ``result``; its device
loop finishes call *k* (chunk syncs, rewind, pack) before it launches call
*k+1*, so the producer's dispatch-then-drain keeps the sequential calls'
carry order while the drain of *k* overlaps *k+1*'s rounds.  With
``REPRO_OBS_TRACE=1`` the request path (``serve.request``,
``serve.lock_wait``, ``serve.queue_wait``, ``serve.assemble``) and the
producer's wait on a full queue (``serve.put_wait``) are host spans of
:mod:`repro_torch.obs`.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import obs
from ..core.union_sampler import SampleSet, SamplerStats


class SampleService:
    """Prefetching, request-batching facade over one or more sample engines."""

    def __init__(self, samplers, batch: int = 4096, prefetch: int = 2):
        if not isinstance(samplers, (list, tuple)):
            samplers = [samplers]
        if not samplers:
            raise ValueError("SampleService needs at least one engine")
        self.samplers = list(samplers)
        self.batch = int(batch)
        self.prefetch = int(prefetch)
        self.attrs = list(self.samplers[0].attrs)
        self._queue: "queue.Queue[SampleSet]" = queue.Queue(
            maxsize=max(self.prefetch, 1))
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._threads: List[threading.Thread] = []
        self._cursor: Optional[SampleSet] = None    # partially drained batch
        self._cursor_pos = 0
        self._lock = threading.Lock()               # request serialisation
        self.served = 0
        self._obs_m: Optional[Dict] = None
        self._collector = None

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "SampleService":
        """Spawn the producer threads.  A service is single-use: once
        stopped it cannot restart (a producer may still be inside a long
        engine round when ``stop`` returns, and the engines are not
        thread-safe — build a fresh service instead)."""
        if self._threads:
            return self
        if self._stop.is_set():
            raise RuntimeError("SampleService is single-use: build a new "
                               "service instead of restarting a stopped one")
        if obs.enabled():
            self._obs_handles()
        for i, s in enumerate(self.samplers):
            t = threading.Thread(target=self._produce, args=(s,),
                                 name=f"sample-producer-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        # unblock producers waiting on a full queue
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        for t in self._threads:
            t.join(timeout=5)
        self._threads = []
        if self._collector is not None:     # single-use: stop scraping us
            reg, fn = self._collector
            fn()        # final quantile/engine refresh (producers quiesced)
            reg.remove_collector(fn)
            self._collector = None

    def __enter__(self) -> "SampleService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------------- producer
    def _produce(self, sampler) -> None:
        """Keep the queue warm with ``batch``-sized sample sets.

        Engines exposing ``sample_async`` get double-buffered round
        dispatch: batch *k+1* is dispatched before batch *k* is drained.
        With the torch engine's device loop that overlaps host and device
        work: dispatching *k+1* finishes *k* (its chunk sync, pack and the
        start of its copy to the host) and returns with *k+1*'s first
        chunk queued on the card, so the drain of *k* (the wait on its
        copy, the fingerprints and the counter fold) runs on the host
        while the card runs *k+1*.  The engine counts such drains in
        ``overlapped_drains``.  Plain engines fall back to the synchronous
        path.
        """
        dispatch = getattr(sampler, "sample_async", None)
        pending = None
        while not self._stop.is_set():
            try:
                if dispatch is None:
                    ss = sampler.sample(self.batch)
                else:
                    if pending is None:
                        pending = dispatch(self.batch)
                    nxt = dispatch(self.batch)     # in flight while we drain
                    ss = pending.result()
                    pending = nxt
            except BaseException as e:        # surfaced on the next request
                self._error = e
                self._stop.set()
                return
            with obs.span("serve.put_wait"):
                while not self._stop.is_set():
                    try:
                        self._queue.put(ss, timeout=0.1)
                        break
                    except queue.Full:
                        continue

    # -------------------------------------------------------------- consumer
    def _next_batch(self, timeout: float) -> SampleSet:
        while True:
            if self._error is not None:
                raise RuntimeError("sample producer failed") from self._error
            try:
                with obs.span("serve.queue_wait"):
                    return self._queue.get(timeout=min(timeout, 0.2))
            except queue.Empty:
                timeout -= 0.2
                if timeout <= 0:
                    raise TimeoutError(
                        "SampleService.request timed out (engine too slow "
                        "for the requested size, or service not started)")

    # ------------------------------------------------------------- telemetry
    def _obs_handles(self) -> Dict:
        """Serve-tier metric handles (get-or-create in the registry); the
        queue-depth gauge and p50/p99 + per-replica stat gauges refresh at
        scrape time via a registry collector (removed again on stop)."""
        if self._obs_m is None:
            reg = obs.get_registry()
            m = {
                "latency": reg.histogram(
                    "repro_serve_request_seconds",
                    "end-to-end SampleService.request latency"),
                "requests": reg.counter(
                    "repro_serve_requests_total",
                    "sample requests served"),
                "samples": reg.counter(
                    "repro_serve_samples_total",
                    "union samples handed out by the serve tier"),
                "queue": reg.gauge(
                    "repro_serve_queue_depth",
                    "prefetch queue occupancy (batches ready to serve)"),
                "capacity": reg.gauge(
                    "repro_serve_prefetch_capacity",
                    "prefetch queue capacity (batches)"),
                "p50": reg.gauge(
                    "repro_serve_request_seconds_p50",
                    "median request latency (bucket-interpolated)"),
                "p99": reg.gauge(
                    "repro_serve_request_seconds_p99",
                    "p99 request latency (bucket-interpolated)"),
                "engine": reg.gauge(
                    "repro_serve_engine_stat",
                    "per-replica engine SamplerStats fields",
                    labelnames=("replica", "field")),
            }
            m["queue"].set_function(self._queue.qsize)
            m["capacity"].set(self._queue.maxsize)

            def collect():
                m["p50"].set(m["latency"].quantile(0.5))
                m["p99"].set(m["latency"].quantile(0.99))
                for i, s in enumerate(self.samplers):
                    for field, v in s.stats.as_dict().items():
                        m["engine"].labels(str(i), field).set(v)
                    # derived waste ratio: candidate draws per emitted sample
                    m["engine"].labels(str(i), "psi").set(s.stats.psi())

            reg.add_collector(collect)
            self._collector = (reg, collect)
            self._obs_m = m
        return self._obs_m

    def request(self, n: int, timeout: float = 120.0) -> SampleSet:
        """Blocking request for ``n`` uniform union samples."""
        if not self._threads:
            raise RuntimeError("SampleService not started (use start() or a "
                               "with-block)")
        t0 = time.perf_counter() if obs.enabled() else None
        if n <= 0:
            from ..core.union_sampler import empty_sample_set
            return empty_sample_set(self.attrs, self.stats())
        with obs.span("serve.request"):
            ss = self._take(n, timeout)
        if t0 is not None:
            m = self._obs_handles()
            m["latency"].observe(time.perf_counter() - t0)
            m["requests"].inc()
            m["samples"].inc(len(ss))
        return ss

    def _take(self, n: int, timeout: float) -> SampleSet:
        """``n`` rows off the stream: the batches' ranges under the lock,
        then their rows copied into one set outside it."""
        parts: List[Tuple[SampleSet, int, int]] = []
        got = 0
        with obs.span("serve.lock_wait"):
            self._lock.acquire()
        try:
            while got < n:
                if self._cursor is None:
                    self._cursor = self._next_batch(timeout)
                    self._cursor_pos = 0
                cur, lo = self._cursor, self._cursor_pos
                hi = min(lo + n - got, len(cur))
                parts.append((cur, lo, hi))
                got += hi - lo
                if hi >= len(cur):
                    self._cursor = None
                else:
                    self._cursor_pos = hi
            self.served += got
        finally:
            self._lock.release()
        with obs.span("serve.assemble"):
            rows = {a: np.concatenate([p.rows[a][lo:hi] for p, lo, hi in parts])
                    for a in self.attrs}
            home = np.concatenate([p.home[lo:hi] for p, lo, hi in parts])
            fp = np.concatenate([p.fingerprint[lo:hi] for p, lo, hi in parts])
            return SampleSet(self.attrs, rows, home, fp, self.stats())

    def stats(self) -> SamplerStats:
        """Merged cost accounting across all engines (associative merge)."""
        out = SamplerStats()
        for s in self.samplers:
            out.merge(s.stats)
        return out
