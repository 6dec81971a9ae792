"""Distributed union sampling: replicas that need no coordination.

Port of ``repro.core.distributed``.  Two uniformity-preserving schemes:

* **seed-split** (default) — probe-mode Algorithm 1 is stateless across
  samples: each accepted tuple is an independent ``1/|U|`` draw.  Host ``h``
  runs its own sampler on seed ``seed * 1_000_003 + h``; the interleaved
  global stream is i.i.d. uniform.  ``mesh=`` puts each replica's rounds on
  the sharded engine of :mod:`repro_torch.core.sharding`.
* **hash-partition** — host ``h`` additionally rejects candidates outside
  fingerprint partition ``h`` (:func:`partition_of`), so each host's stream
  is uniform over its partition ``U_h``.  The sharded engine's membership
  ownership (:func:`repro_torch.core.sharding.partition_of_fp32`) is the
  intra-host analogue of this partition.

Estimator statistics (:class:`RunningMean`) are associative, so cross-host
refinement is one all-gather and a merge (:func:`merge_statistics`); the
on-mesh form of the same merge is
:func:`repro_torch.core.sharding.psum_merge_moments`.  Sample-stream cost
accounting merges with :meth:`SamplerStats.merge`.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .cover import Cover
from .index import Catalog
from .joins import JoinSpec
from .size_estimation import RunningMean
from .union_sampler import SampleSet, SamplerStats, SetUnionSampler


def partition_of(fingerprint: np.ndarray, world: int) -> np.ndarray:
    """Partition id per sample from the primary 64-bit fingerprint."""
    return (fingerprint[:, 0] % np.uint64(world)).astype(np.int64)


class DistributedUnionSampler:
    """Per-host wrapper around :class:`SetUnionSampler`.

    ``backend``, ``mesh``, ``round_batch`` and ``device`` forward to the
    inner sampler (``device=None`` means the card)."""

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec], cover: Cover,
                 rank: int, world: int, scheme: str = "seed-split",
                 membership: str = "probe", seed: int = 0,
                 backend="torch", mesh=None, round_batch: int = 4096,
                 device=None):
        if scheme not in ("seed-split", "hash-partition"):
            raise ValueError(f"unknown scheme {scheme!r}")
        if scheme == "seed-split" and membership != "probe":
            raise ValueError("seed-split requires the stateless probe mode")
        self.rank, self.world, self.scheme = rank, world, scheme
        self.inner = SetUnionSampler(
            cat, joins, cover, membership=membership,
            seed=seed * 1_000_003 + rank, backend=backend, mesh=mesh,
            round_batch=round_batch, device=device)
        self.attrs = self.inner.attrs

    @property
    def stats(self) -> SamplerStats:
        return self.inner.stats

    def sample(self, n: int, oversample: float = 1.5,
               max_rounds: int = 64) -> SampleSet:
        if self.scheme == "seed-split":
            return self.inner.sample(n)
        # hash-partition: keep only this rank's partition (extra rejection)
        got_rows: List[Dict[str, np.ndarray]] = []
        got_home: List[np.ndarray] = []
        got_fp: List[np.ndarray] = []
        count = 0
        grow = 1.0          # geometric growth across under-filled rounds
        for _ in range(max_rounds):
            want = max(int((n - count) * self.world * oversample * grow), 32)
            ss = self.inner.sample(want)
            mine = partition_of(ss.fingerprint, self.world) == self.rank
            idx = np.nonzero(mine)[0]
            if idx.shape[0]:
                got_rows.append({a: c[idx] for a, c in ss.rows.items()})
                got_home.append(ss.home[idx])
                got_fp.append(ss.fingerprint[idx])
                count += idx.shape[0]
            if count >= n:
                break
            # under-filled round: this partition holds less than the assumed
            # |U|/world share, so a fixed oversample can stall just short of
            # the target — widen the next request geometrically
            grow = min(grow * 2.0, 64.0)
        if count < n:
            raise RuntimeError(
                f"hash-partition sampler under-filled: got {count} of {n} "
                f"requested samples for partition {self.rank}/{self.world} "
                f"after {max_rounds} rounds (raise max_rounds/oversample)")
        rows = {a: np.concatenate([r[a] for r in got_rows])[:n]
                for a in got_rows[0]}
        return SampleSet(self.inner.attrs, rows,
                         np.concatenate(got_home)[:n],
                         np.concatenate(got_fp)[:n],
                         self.inner.stats)


def merge_statistics(stats: Sequence[RunningMean]) -> RunningMean:
    """All-gather + associative merge of per-host estimator statistics."""
    out = RunningMean()
    for s in stats:
        out.merge(s)
    return out


def merge_streams(parts: Sequence[SampleSet], seed: int = 0) -> SampleSet:
    """Interleave per-host sample streams into one global stream."""
    rng = np.random.default_rng(seed)
    attrs = parts[0].attrs
    rows = {a: np.concatenate([p.rows[a] for p in parts]) for a in attrs}
    home = np.concatenate([p.home for p in parts])
    fp = np.concatenate([p.fingerprint for p in parts])
    perm = rng.permutation(home.shape[0])
    stats = SamplerStats()
    for p in parts:
        stats.merge(p.stats)
    return SampleSet(attrs, {a: c[perm] for a, c in rows.items()},
                     home[perm], fp[perm], stats)
