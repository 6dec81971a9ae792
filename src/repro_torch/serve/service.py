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

Port copy of ``repro.serve.service`` without its telemetry (the metrics
registry and the ``/metrics`` endpoint that reads it are not ported yet);
``python -m repro_torch.launch.serve --mode samples`` routes through this
class.  The torch engine pins its own device and CUDA stream inside
``sample_async``, so the producer thread launches on the sampler's stream.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional

import numpy as np

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

    def __enter__(self) -> "SampleService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -------------------------------------------------------------- producer
    def _produce(self, sampler) -> None:
        """Keep the queue warm with ``batch``-sized sample sets.

        Engines exposing ``sample_async`` get double-buffered round
        dispatch: batch *k+1* is launched before batch *k* is drained, so
        the host-side assembly (fetch, shuffle, fingerprint) of one batch
        hides behind the device compute of the next — the fused device
        loop's top-up latency never stalls the queue.  Plain engines fall
        back to the synchronous path.
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
                return self._queue.get(timeout=min(timeout, 0.2))
            except queue.Empty:
                timeout -= 0.2
                if timeout <= 0:
                    raise TimeoutError(
                        "SampleService.request timed out (engine too slow "
                        "for the requested size, or service not started)")

    def request(self, n: int, timeout: float = 120.0) -> SampleSet:
        """Blocking request for ``n`` uniform union samples."""
        if not self._threads:
            raise RuntimeError("SampleService not started (use start() or a "
                               "with-block)")
        if n <= 0:
            from ..core.union_sampler import empty_sample_set
            return empty_sample_set(self.attrs, self.stats())
        parts: List[SampleSet] = []
        got = 0
        with self._lock:
            while got < n:
                if self._cursor is None:
                    self._cursor = self._next_batch(timeout)
                    self._cursor_pos = 0
                cur, lo = self._cursor, self._cursor_pos
                hi = min(lo + n - got, len(cur))
                parts.append(SampleSet(
                    cur.attrs, {a: c[lo:hi] for a, c in cur.rows.items()},
                    cur.home[lo:hi], cur.fingerprint[lo:hi], cur.stats))
                got += hi - lo
                if hi >= len(cur):
                    self._cursor = None
                else:
                    self._cursor_pos = hi
            self.served += got
        rows = {a: np.concatenate([p.rows[a] for p in parts])
                for a in self.attrs}
        home = np.concatenate([p.home for p in parts])
        fp = np.concatenate([p.fingerprint for p in parts])
        return SampleSet(self.attrs, rows, home, fp, self.stats())

    def stats(self) -> SamplerStats:
        """Merged cost accounting across all engines (associative merge)."""
        out = SamplerStats()
        for s in self.samplers:
            out.merge(s.stats)
        return out
