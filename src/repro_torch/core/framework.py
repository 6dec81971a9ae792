"""Facade: warm-up → parameter oracle → cover (paper Fig. overview).

Port copy of ``repro.core.framework`` for the two host estimation methods of
this slice.  ``warmup(cat, joins, method)`` builds the
:class:`OverlapOracle` backing both Theorem 3 (union size, Eq. 1
diagnostics) and the cover sizes of Algorithm 1:

* ``exact``      — FULLJOIN ground truth (tests / small data only),
* ``histogram``  — §5 degree-statistics bounds (decentralised setting).

Both handle cyclic (§8.2 skeleton+residual) members: ``exact`` counts
distinct tuples of the materialised join, and the histogram algebra treats
residual edges as links to their earlier relations.  Joins with §8.3
rejection predicates are counted after the filter (``exact``) or scaled by
their estimated selectivity (``histogram``).  The random-walk method waits
for the port of the estimators.
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
    aux: object = None  # HistogramOverlap instance (histogram method)


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


def warmup(cat: Catalog, joins: Sequence[JoinSpec], method: str = "exact"
           ) -> WarmupResult:
    """Build the parameter oracle on the host (numpy estimation)."""
    joins = list(joins)
    t0 = time.perf_counter()
    if method == "exact":
        oracle = OverlapOracle(lambda d: exact_overlap(cat, d),
                               _exact_size_fn(cat), joins)
        aux = None
    elif method == "histogram":
        hist = HistogramOverlap(cat, joins)
        est_fn = hist.estimate
        if any(j.reject_preds for j in joins):
            # §8.3 rejection predicates: overlaps of filtered joins shrink by
            # (at least) the most selective member's predicate; olken_bound
            # scales per-join internally
            from .predicates import scaled_overlap_estimate
            est_fn = scaled_overlap_estimate(hist.estimate)
        oracle = OverlapOracle(est_fn, lambda j: olken_bound(cat, j), joins)
        aux = hist
    else:
        raise ValueError(f"unknown warmup method {method!r} "
                         "(expected 'exact' or 'histogram')")
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
