"""Estimator backend contracts — §5–§7 size/overlap estimation.

Port copy of ``repro.core.estimators.base``.  The ONLINE-UNION sampler
(Algorithm 2) and the random-walk warm-up consume a small estimation
surface:

* batched **wander-join observation**: walk a pivot join, probe the walk
  endpoints for membership in the other joins of ``Δ``, and fold the
  Horvitz–Thompson draws ``indicator(t)/p(t)`` into running mean/variance
  accumulators (``observe`` / ``estimate`` / ``join_size``),
* **accumulator views**: per-join size statistics and per-Δ overlap
  statistics exposed as :class:`StatView` objects (mean / count /
  CI half-width — the quantities Algorithm 2's refinement and backtracking
  read),
* a **walk pool**: completed walk tuples with their exact probabilities,
  drained by the reuse phase of §7 (``drain_pool``),
* a **histogram oracle** for the cheap §5 initialisation (``histogram``).

The port has one implementation, :class:`~repro_torch.core.estimators.
torch_estimator.TorchEstimator` (walk batches, membership probes and the HT
reduction on the card).
"""

from __future__ import annotations

import dataclasses
from typing import (Dict, FrozenSet, List, Mapping, Optional, Protocol,
                    Sequence, Tuple, runtime_checkable)

import numpy as np

from ..joins import JoinSpec

Rows = Dict[str, np.ndarray]
PoolBatch = Tuple[Rows, np.ndarray]          # (walk rows, walk probabilities)


@dataclasses.dataclass
class OverlapEstimate:
    """Point estimate of |O_Δ| with its CI half-width and walk count."""

    value: float
    half_width: float
    walks: int


@runtime_checkable
class StatView(Protocol):
    """Read surface of a running mean/variance accumulator (host or device)."""

    @property
    def count(self) -> int: ...

    @property
    def mean(self) -> float: ...

    @property
    def variance(self) -> float: ...

    def half_width(self, confidence: float = 0.90) -> float: ...


@runtime_checkable
class EstimatorBackend(Protocol):
    """Batched wander-join estimation over one union of joins."""

    name: str

    def observe(self, delta: Sequence[JoinSpec], rounds: int = 1
                ) -> OverlapEstimate:
        """Run ``rounds`` walk batches on Δ's pivot; update |J| and |O_Δ|."""
        ...

    def estimate(self, delta: Sequence[JoinSpec], confidence: float = 0.90,
                 rel_halfwidth: float = 0.25, max_walks: int = 50_000,
                 min_walks: int = 512) -> OverlapEstimate:
        """Walk until the CI is tight (or budget exhausted); Eq. 2 estimate."""
        ...

    def join_size(self, join: JoinSpec, min_walks: int = 512) -> float:
        """HT size estimate of one join (walked as a Δ of size 1)."""
        ...

    @property
    def size_stats(self) -> Mapping[str, StatView]:
        """Per-join |J| accumulators, keyed by join name."""
        ...

    @property
    def overlap_stats(self) -> Mapping[FrozenSet[str], StatView]:
        """Per-Δ |O_Δ| accumulators, keyed by frozenset of join names."""
        ...

    def drain_pool(self) -> Dict[str, List[PoolBatch]]:
        """Hand the accumulated walk pool to the caller and reset it (§7)."""
        ...

    def histogram(self, mode: str = "max"):
        """§5 degree-statistics overlap estimator for cheap initialisation."""
        ...


class EstimationLoop:
    """Shared control flow over an ``observe``-driven estimator.

    Pivot selection and the CI stopping rules live here once so the host and
    device engines cannot diverge; subclasses supply ``observe`` plus the
    ``cat`` / ``_stats`` / ``_size_stats`` attributes it updates.
    """

    def _pivot(self, delta: Sequence[JoinSpec]) -> JoinSpec:
        # pivot = join with the smallest Olken bound (lowest-variance walks)
        from ..size_estimation import olken_bound
        return min(delta, key=lambda j: olken_bound(self.cat, j))

    def estimate(self, delta: Sequence[JoinSpec], confidence: float = 0.90,
                 rel_halfwidth: float = 0.25, max_walks: int = 50_000,
                 min_walks: int = 512) -> OverlapEstimate:
        """Walk until the CI is tight (or budget exhausted); Eq. 2 estimate."""
        delta = list(delta)
        key = frozenset(j.name for j in delta)
        while True:
            est = self.observe(delta, rounds=1)
            stat = self._stats[key]
            if stat.count >= min_walks:
                hw = stat.half_width(confidence)
                if est.value <= 0 and stat.count >= min_walks * 4:
                    break  # looks empty
                if est.value > 0 and hw <= rel_halfwidth * est.value:
                    break
            if stat.count >= max_walks:
                break
        stat = self._stats[key]
        return OverlapEstimate(max(stat.mean, 0.0), stat.half_width(confidence),
                               stat.count)

    def join_size(self, join: JoinSpec, min_walks: int = 512) -> float:
        """HT size of one join (walked as a Δ of size 1)."""
        st = self._size_stats.get(join.name)
        while st is None or st.count < min_walks:
            self.observe([join], rounds=1)
            st = self._size_stats[join.name]
        return max(st.mean, 0.0)


class ReservoirPool:
    """Bounded per-join pool of walk batches (reservoir over batches).

    ``observe`` produces one ``(rows, prob)`` batch per round; an unbounded
    run would append forever.  Up to ``cap`` batches per join are kept
    verbatim (behaviour-identical to the historical unbounded pool for any
    run that stays under the cap); beyond that, batch ``i`` replaces a
    uniformly random slot with probability ``cap/i`` (Algorithm R), so the
    retained batches stay a uniform sample of all batches seen.  A dedicated
    generator drives the replacement draws so engaging the cap never
    perturbs the estimator's main random stream.
    """

    def __init__(self, cap: int = 512, seed: int = 0):
        if cap <= 0:
            raise ValueError(f"pool cap must be positive, got {cap}")
        self.cap = int(cap)
        self.pools: Dict[str, List[PoolBatch]] = {}
        self._seen: Dict[str, int] = {}
        self._rng = np.random.default_rng(np.uint64(seed) ^ np.uint64(0x9E3779B97F4A7C15))

    def add(self, name: str, batch: PoolBatch) -> None:
        pool = self.pools.setdefault(name, [])
        seen = self._seen.get(name, 0)
        if len(pool) < self.cap:
            pool.append(batch)
        else:
            slot = int(self._rng.integers(0, seen + 1))
            if slot < self.cap:
                pool[slot] = batch
        self._seen[name] = seen + 1

    def drain(self) -> Dict[str, List[PoolBatch]]:
        out = self.pools
        self.pools = {}
        self._seen = {}
        return out

    def n_batches(self, name: str) -> int:
        return len(self.pools.get(name, []))
