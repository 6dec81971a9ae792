"""Training data pipeline over the union sampler.

The port's copy of the reference's ``repro/data/pipeline.py``.
``UnionSamplePipeline`` turns any :class:`SampleSet`-producing sampler into
a stream of fixed-shape ``(batch, seq_len)`` token batches (numpy int32 on
the host; the trainer moves each batch to the device once per step):

* **per-host sharding** — seed-split: each data-parallel host owns an
  independent sampler seed; the global stream stays i.i.d. uniform with no
  coordination.
* **prefetch + straggler mitigation** — a bounded background queue; if a
  batch misses its deadline the host *skips* it and logs
  (``stats.skipped``): the stream is i.i.d., so dropping a straggler's batch
  is statistically free.
* **checkpointable state** — the sampler's numpy ``rng`` state and the
  counters, saved with the model checkpoint.  As in the reference, the
  device engine's uniform stream (the port's Philox generator) is not part
  of it, so a restore does not resume the same draws.

Streams on the card: the device engine pins the CUDA stream that was
current when it was built (``TorchUnionSampler._on_device``), so its graph
replays run there from whichever thread calls; the prefetch worker thus
runs the sampler on the sampler's stream while the trainer's work runs on
its own.  :func:`repro_torch.launch.train.build_pipeline` builds the
sampler under a stream of its own.  Every batch reaches the host (numpy)
before it is queued, so the two streams share no tensor.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..core.union_sampler import SampleSet
from .encode import TokenEncoder


@dataclasses.dataclass
class PipelineStats:
    batches: int = 0
    tuples: int = 0
    skipped: int = 0
    sample_seconds: float = 0.0


class UnionSamplePipeline:
    """Fixed-shape token batches from a union sampler."""

    def __init__(self, sampler, encoder: TokenEncoder, batch: int,
                 seq_len: int, host_rank: int = 0, host_world: int = 1,
                 prefetch: int = 2, deadline_s: Optional[float] = None):
        self.sampler = sampler
        self.encoder = encoder
        self.batch = batch
        self.seq_len = seq_len
        self.host_rank = host_rank
        self.host_world = host_world
        self.deadline_s = deadline_s
        self.stats = PipelineStats()
        per_seq = max((seq_len - 1) // encoder.tokens_per_tuple, 1)
        self._tuples_per_batch = per_seq * batch
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # -- synchronous path ------------------------------------------------------
    def _fill(self) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        ss: SampleSet = self.sampler.sample(self._tuples_per_batch)
        self.stats.sample_seconds += time.perf_counter() - t0
        self.stats.tuples += len(ss)
        return ss.rows

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        rows = self._fill()
        tokens, targets, _ = self.encoder.pack(rows, self.batch, self.seq_len)
        self.stats.batches += 1
        return tokens, targets

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            yield self.next_batch()

    # -- prefetching path ------------------------------------------------------
    def start_prefetch(self) -> None:
        if self._thread is not None:
            return

        def worker() -> None:
            while not self._stop.is_set():
                try:
                    b = self.next_batch()
                except Exception:  # propagate through the queue
                    self._q.put(None)
                    return
                self._q.put(b)
        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def next_batch_prefetched(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Prefetched batch; returns None (and logs a skip) on deadline miss."""
        self.start_prefetch()
        try:
            b = self._q.get(timeout=self.deadline_s) if self.deadline_s else self._q.get()
        except queue.Empty:
            self.stats.skipped += 1
            return None
        if b is None:
            raise RuntimeError("pipeline worker failed")
        return b

    def stop(self) -> None:
        self._stop.set()

    # -- checkpointing ---------------------------------------------------------
    def state_dict(self) -> Dict[str, object]:
        rng_state = None
        rng = getattr(self.sampler, "rng", None)
        if rng is not None:
            rng_state = rng.bit_generator.state
        return {"stats": dataclasses.asdict(self.stats), "rng_state": rng_state,
                "host_rank": self.host_rank, "host_world": self.host_world}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        self.stats = PipelineStats(**state["stats"])  # type: ignore[arg-type]
        rng = getattr(self.sampler, "rng", None)
        if rng is not None and state.get("rng_state") is not None:
            rng.bit_generator.state = state["rng_state"]


class SyntheticPipeline:
    """PRNG token stream with the same interface (smoke tests / dry-runs)."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int, seed: int = 0):
        self.vocab_size, self.batch, self.seq_len = vocab_size, batch, seq_len
        self.rng = np.random.default_rng(seed)
        self.stats = PipelineStats()

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        tokens = self.rng.integers(4, self.vocab_size, (self.batch, self.seq_len),
                                   dtype=np.int64).astype(np.int32)
        targets = np.concatenate([tokens[:, 1:], np.zeros((self.batch, 1), np.int32)], 1)
        self.stats.batches += 1
        return tokens, targets

    def __iter__(self):
        while True:
            yield self.next_batch()
