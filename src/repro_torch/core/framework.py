"""Facade: warm-up → parameter oracle → cover (paper Fig. overview).

Port copy of ``repro.core.framework``.  ``warmup(cat, joins, method)``
builds the :class:`OverlapOracle` backing both Theorem 3 (union size, Eq. 1
diagnostics) and the cover sizes of Algorithm 1:

* ``exact``        — FULLJOIN ground truth (tests / small data only),
* ``histogram``    — §5 degree-statistics bounds (decentralised setting),
  on the host,
* ``random_walk``  — §6 wander-join estimates (centralised setting): walks,
  membership probes and HT accumulation on the card
  (:class:`~repro_torch.core.estimators.torch_estimator.TorchEstimator`).

All three handle cyclic (§8.2 skeleton+residual) members: ``exact`` counts
distinct tuples of the materialised join, the histogram algebra treats
residual edges as links to their earlier relations, and wander-join walks
hop residual edges like any other.  Joins with §8.3 rejection predicates
are counted after the filter (``exact``) or scaled by their estimated
selectivity (``histogram``, ``random_walk``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

from .cover import Cover, build_cover
from .index import Catalog
from .joins import JoinSpec
from .join_sampler import JoinSampler
from .koverlap import KOverlaps, OverlapOracle, k_overlaps
from .overlap import HistogramOverlap, exact_join_size_distinct, exact_overlap
from .size_estimation import olken_bound


@dataclasses.dataclass
class WarmupResult:
    oracle: OverlapOracle
    method: str
    seconds: float
    aux: object = None  # HistogramOverlap / TorchEstimator instance


def _exact_size_fn(cat: Catalog):
    def f(j: JoinSpec) -> float:
        if j.is_cyclic or j.reject_preds:
            # cyclic: residual edges; reject_preds: the filtered join must be
            # counted — both need the materialised distinct count
            return float(exact_join_size_distinct(cat, j))
        # duplicate-free base relations => join output duplicate-free, so the
        # EW total weight IS the distinct size (cheap, no materialisation).
        return JoinSampler(cat, j).exact_acyclic_size()
    return f


def warmup(cat: Catalog, joins: Sequence[JoinSpec], method: str = "exact",
           seed: int = 0, rw_batch: int = 512,
           rw_rel_halfwidth: float = 0.25,
           rw_max_walks: int = 20_000,
           hist_mode: str = "max", device=None,
           uniforms=None, mesh=None) -> WarmupResult:
    """Build the parameter oracle.  ``exact`` and ``histogram`` run on the
    host; ``random_walk`` runs its walks on ``device`` (``None`` means the
    card and raises without one), seeded from ``seed`` unless ``uniforms``
    replaces the walk stream.  ``mesh`` (random_walk only) spreads each walk
    batch across the mesh's ranks with a merge of the moments over the mesh
    (see :mod:`repro_torch.core.sharding.stats`).  The oracle is lazy: the
    walks run when the cover or the k-overlaps ask for an estimate."""
    joins = list(joins)
    if mesh is not None and method != "random_walk":
        raise ValueError("mesh= applies to method='random_walk' only")
    t0 = time.perf_counter()
    if method == "exact":
        oracle = OverlapOracle(lambda d: exact_overlap(cat, d),
                               _exact_size_fn(cat), joins)
        aux = None
    elif method == "histogram":
        hist = HistogramOverlap(cat, joins, mode=hist_mode)
        est_fn = hist.estimate
        if any(j.reject_preds for j in joins):
            # §8.3 rejection predicates: overlaps of filtered joins shrink by
            # (at least) the most selective member's predicate; olken_bound
            # scales per-join internally
            from .predicates import scaled_overlap_estimate
            est_fn = scaled_overlap_estimate(hist.estimate)
        oracle = OverlapOracle(est_fn, lambda j: olken_bound(cat, j), joins)
        aux = hist
    elif method == "random_walk":
        from .estimators import get_estimator
        rw = get_estimator("torch", cat, joins, seed=seed, batch=rw_batch,
                           device=device, uniforms=uniforms, mesh=mesh)
        est_fn = (lambda d: rw.estimate(d, rel_halfwidth=rw_rel_halfwidth,
                                        max_walks=rw_max_walks).value)
        size_fn = rw.join_size
        if any(j.reject_preds for j in joins):
            # walks sample the unfiltered joins; scale both estimates by the
            # predicate selectivity (membership probes are already pred-aware)
            from .predicates import scaled_overlap_estimate, scaled_size_fn
            est_fn = scaled_overlap_estimate(est_fn)
            size_fn = scaled_size_fn(size_fn)
        oracle = OverlapOracle(est_fn, size_fn, joins)
        aux = rw
    else:
        raise ValueError(f"unknown warmup method {method!r}")
    return WarmupResult(oracle, method, time.perf_counter() - t0, aux)


@dataclasses.dataclass
class UnionEstimates:
    cover: Cover
    koverlaps: KOverlaps
    union_size_cover: float     # Σ |J'_i| (drives Algorithm 1's selection)
    union_size_eq1: float       # Eq. 1 via Theorem 3 (diagnostic consistency)


def estimate_union(oracle: OverlapOracle,
                   order: Optional[Sequence[str]] = None) -> UnionEstimates:
    cover = build_cover(oracle, order)
    ko = k_overlaps(oracle)
    return UnionEstimates(cover, ko, cover.union_size, ko.union_size())
