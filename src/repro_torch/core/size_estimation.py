"""The extended Olken join-size bound (paper §3.2).

Port copy of ``repro.core.size_estimation.olken_bound``:
``|J| <= |R_1| * prod_i M_{A_i}(R_{i+1})`` generalised to trees and cyclic
joins as the product of per-edge max degrees, scaled by the estimated
selectivity of a join's §8.3 rejection predicates.
"""

from __future__ import annotations

from .index import Catalog
from .joins import JoinSpec


def olken_bound(cat: Catalog, spec: JoinSpec) -> float:
    """Extended Olken upper bound on |J|.

    Joins carrying §8.3 rejection predicates are scaled by the estimated
    predicate selectivity — the bound must describe the *filtered* join the
    sampler targets (see predicates.selectivity_factor)."""
    order = spec.expansion_order()
    b = float(order[0].relation.nrows)
    for n in order[1:]:
        idx = cat.index(n.relation, list(n.edge_attrs))
        b *= max(idx.max_degree(), 0)
    if spec.reject_preds:
        from .predicates import selectivity_factor
        b *= selectivity_factor(spec)
    return b
