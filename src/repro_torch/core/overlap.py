"""Overlap-size estimation |O_Δ| for a set Δ of joins.

Port copy of ``repro.core.overlap`` with its two host instantiations (the
random-walk estimator runs on the card:
:class:`~repro_torch.core.estimators.torch_estimator.TorchEstimator`):

* :func:`exact_overlap`       — materialise the joins and intersect distinct
  tuple sets (the FULLJOIN ground truth; exponential-cost baseline).
* :class:`HistogramOverlap`   — §5 / Theorem 4: degree-statistics upper bound
  over template-split chains.  Needs only per-column histograms — the
  *decentralised* (data-market) setting.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .index import Catalog
from .joins import JoinSpec, full_join_matrix
from .size_estimation import olken_bound
from .splitting import SplitPlan, split_plans

__all__ = [
    "HistogramOverlap", "exact_join_size_distinct", "exact_overlap",
    "exact_union_size",
]


# ---------------------------------------------------------------------------
# Exact (FULLJOIN baseline)
# ---------------------------------------------------------------------------


def _row_view(mat: np.ndarray) -> np.ndarray:
    """View an (n,k) int64 matrix as an (n,) structured array for set ops."""
    mat = np.ascontiguousarray(mat)
    return mat.view([("", mat.dtype)] * mat.shape[1]).ravel()


def distinct_tuples(mat: np.ndarray) -> np.ndarray:
    return np.unique(_row_view(mat))


def exact_overlap(cat: Catalog, joins: Sequence[JoinSpec],
                  attrs: Optional[Sequence[str]] = None) -> int:
    """|∩_{J in joins} J| over distinct output tuples (expensive baseline)."""
    attrs = list(attrs) if attrs is not None else sorted(joins[0].output_attrs)
    sets = [distinct_tuples(full_join_matrix(cat, j, attrs)) for j in joins]
    cur = sets[0]
    for s in sets[1:]:
        cur = np.intersect1d(cur, s, assume_unique=True)
        if cur.shape[0] == 0:
            break
    return int(cur.shape[0])


def exact_union_size(cat: Catalog, joins: Sequence[JoinSpec],
                     attrs: Optional[Sequence[str]] = None) -> int:
    attrs = list(attrs) if attrs is not None else sorted(joins[0].output_attrs)
    sets = [distinct_tuples(full_join_matrix(cat, j, attrs)) for j in joins]
    cur = sets[0]
    for s in sets[1:]:
        cur = np.union1d(cur, s)
    return int(cur.shape[0])


def exact_join_size_distinct(cat: Catalog, join: JoinSpec,
                             attrs: Optional[Sequence[str]] = None) -> int:
    attrs = list(attrs) if attrs is not None else sorted(join.output_attrs)
    return int(distinct_tuples(full_join_matrix(cat, join, attrs)).shape[0])


# ---------------------------------------------------------------------------
# HISTOGRAM-BASED (Theorem 4 over split chains)
# ---------------------------------------------------------------------------


class HistogramOverlap:
    """Degree-statistics upper bound on |O_Δ| (decentralised setting)."""

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec],
                 mode: str = "max", cap_with_join_bound: bool = True):
        if mode not in ("max", "avg"):
            raise ValueError("mode must be 'max' (bound) or 'avg' (refined estimate)")
        self.cat = cat
        self.joins = list(joins)
        self.mode = mode
        self.cap = cap_with_join_bound
        self.plans: Dict[str, SplitPlan] = {
            p.join.name: p for p in split_plans(joins)
        }
        self.template = next(iter(self.plans.values())).template
        self._join_bounds = {j.name: olken_bound(cat, j) for j in joins}

    # -- per-join, per-pair statistics ---------------------------------------
    def _pair_degree_hist(self, plan: SplitPlan, i: int, attr: str
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact per-value histogram of ``attr`` in pair i's source relation."""
        pair = plan.pairs[i]
        if pair.source_alias is not None:
            rel = plan.join.node(pair.source_alias).relation
        else:
            # fallback: use the first relation on the path holding the attr
            alias = next(a for a in pair.path_aliases
                         if attr in plan.join.node(a).relation.attrs)
            rel = plan.join.node(alias).relation
        st = self.cat.stats(rel, [attr])
        return st.hist_values, st.hist_counts

    def _pair_multiplier(self, plan: SplitPlan, i: int) -> float:
        """M_{j,i}: multiplier for extending through pair i (Theorem 4)."""
        pair = plan.pairs[i]
        lead = pair.attrs[0]
        if pair.source_alias is not None:
            if pair.fake_edge_to_prev:
                return 1.0  # fake join — row identity continues
            rel = plan.join.node(pair.source_alias).relation
            st = self.cat.stats(rel, [lead])
            return float(st.max_degree if self.mode == "max" else max(st.avg_degree, 1e-12))
        # path fallback: product of per-hop degrees along the connecting path
        m = 1.0
        for alias in pair.path_aliases:
            rel = plan.join.node(alias).relation
            held = [a for a in pair.attrs if a in rel.attrs]
            st = self.cat.stats(rel, [held[0] if held else rel.attrs[0]])
            m *= float(st.max_degree if self.mode == "max" else max(st.avg_degree, 1e-12))
        return m

    def estimate(self, delta: Sequence[JoinSpec]) -> float:
        """Upper bound (mode='max') or refined estimate (mode='avg') of |O_Δ|."""
        delta = list(delta)
        if len(delta) == 1:
            only = delta[0]
            val = self._join_bounds[only.name]
            return float(val)
        plans = [self.plans[j.name] for j in delta]
        k = len(self.template) - 1  # number of pairs

        # K(1): value-level min over joins on the first edge's shared attr.
        # First edge connects pair 0 and pair 1 on template[1].
        first_attr = self.template[1]
        per_join_value_counts: List[Tuple[np.ndarray, np.ndarray]] = []
        for plan in plans:
            v0, c0 = self._pair_degree_hist(plan, 0, first_attr)
            if k >= 2:
                p1 = plan.pairs[1]
                if p1.fake_edge_to_prev:
                    # row identity: pairs with A2=v == d(v) rows
                    per_join_value_counts.append((v0, c0.astype(np.float64)))
                    continue
                v1, c1 = self._pair_degree_hist(plan, 1, first_attr)
                common, i0, i1 = np.intersect1d(v0, v1, assume_unique=True,
                                                return_indices=True)
                per_join_value_counts.append(
                    (common, c0[i0].astype(np.float64) * c1[i1].astype(np.float64)))
            else:
                per_join_value_counts.append((v0, c0.astype(np.float64)))

        # intersect the value domains across joins and take the min count
        vals = per_join_value_counts[0][0]
        for v, _ in per_join_value_counts[1:]:
            vals = np.intersect1d(vals, v, assume_unique=True)
        if vals.shape[0] == 0:
            return 0.0
        kacc = np.full(vals.shape[0], np.inf)
        for v, c in per_join_value_counts:
            pos = np.searchsorted(v, vals)
            kacc = np.minimum(kacc, c[pos])
        k1 = float(kacc.sum())

        # K(i) for the remaining pairs: multiply by min over joins of M_{j,i}
        bound = k1
        for i in range(2, k):
            bound *= min(self._pair_multiplier(plan, i) for plan in plans)
        if self.cap:
            # an overlap is never larger than its smallest join
            bound = min(bound, min(self._join_bounds[j.name] for j in delta))
        return float(bound)

    def join_size_bound(self, join: JoinSpec) -> float:
        return float(self._join_bounds[join.name])
