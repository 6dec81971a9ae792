"""Host (numpy) estimation engine — port copy of
``repro.core.estimators.numpy_estimator``.

§6.2 / Eq. 2 wander-join overlap estimation and §6.1 HT join sizes from host
walks (:class:`~repro_torch.core.join_sampler.JoinSampler` with
``method="wj"``), behind the
:class:`~repro_torch.core.estimators.base.EstimatorBackend` protocol.  The
random stream, batch shapes and update order are the reference's: a shared
seed reproduces its estimates.  ONLINE-UNION uses it with the numpy
backend, and when a custom backend has no estimator twin.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Mapping, Sequence

import numpy as np

from ..index import Catalog
from ..join_sampler import JoinSampler
from ..joins import JoinSpec
from ..membership import MembershipProber
from ..size_estimation import RunningMean
from .base import EstimationLoop, OverlapEstimate, PoolBatch, ReservoirPool


class NumpyEstimator(EstimationLoop):
    """Unbiased |J| / |O_Δ| estimation from host wander-join walks."""

    name = "numpy"

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec], seed: int = 0,
                 batch: int = 512, pool_cap: int = 512):
        self.cat = cat
        self.joins = list(joins)
        self.by_name = {j.name: j for j in self.joins}
        self.prober = MembershipProber(cat, self.joins)
        self.batch = batch
        self._samplers: Dict[str, JoinSampler] = {}
        self._rng = np.random.default_rng(seed)
        # per-Δ running statistics: HT mean of indicator/p (=|O|) and of 1/p (=|J|)
        self._stats: Dict[FrozenSet[str], RunningMean] = {}
        self._size_stats: Dict[str, RunningMean] = {}
        # reuse pool: walk tuples + probabilities per join (feeds ONLINE-UNION §7)
        self._pool = ReservoirPool(cap=pool_cap, seed=seed)

    # -- walk pool (bounded; `walk_pool` kept as the historical attribute) ----
    @property
    def walk_pool(self) -> Dict[str, List[PoolBatch]]:
        return self._pool.pools

    @walk_pool.setter
    def walk_pool(self, value: Dict[str, List[PoolBatch]]) -> None:
        self._pool.drain()
        for name, batches in value.items():
            for b in batches:
                self._pool.add(name, b)

    def drain_pool(self) -> Dict[str, List[PoolBatch]]:
        return self._pool.drain()

    # -- accumulator views ----------------------------------------------------
    @property
    def size_stats(self) -> Mapping[str, RunningMean]:
        return self._size_stats

    @property
    def overlap_stats(self) -> Mapping[FrozenSet[str], RunningMean]:
        return self._stats

    # -- walks ----------------------------------------------------------------
    def sampler(self, name: str) -> JoinSampler:
        if name not in self._samplers:
            self._samplers[name] = JoinSampler(self.cat, self.by_name[name],
                                               method="wj")
        return self._samplers[name]

    def observe(self, delta: Sequence[JoinSpec], rounds: int = 1
                ) -> OverlapEstimate:
        """Run ``rounds`` batches of walks on the pivot and update estimates."""
        delta = list(delta)
        key = frozenset(j.name for j in delta)
        stat = self._stats.setdefault(key, RunningMean())
        pivot = self._pivot(delta)
        others = [j for j in delta if j.name != pivot.name]
        smp = self.sampler(pivot.name)
        for _ in range(rounds):
            sb = smp.sample_batch(self._rng, self.batch)
            inv = np.where(sb.ok & (sb.prob > 0),
                           1.0 / np.maximum(sb.prob, 1e-300), 0.0)
            self._size_stats.setdefault(pivot.name, RunningMean()).update_batch(inv)
            ind = sb.ok.copy()
            if others and ind.any():
                member = np.ones(self.batch, dtype=bool)
                for j in others:
                    member &= self.prober.contains(j.name, sb.rows)
                ind &= member
            stat.update_batch(np.where(ind, inv, 0.0))
            self._pool.add(pivot.name, (sb.rows, sb.prob))
        return OverlapEstimate(stat.mean, stat.half_width(0.90), stat.count)

    # -- §5 initialisation ----------------------------------------------------
    def histogram(self, mode: str = "max"):
        from ..overlap import HistogramOverlap
        return HistogramOverlap(self.cat, self.joins, mode=mode)
