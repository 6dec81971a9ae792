"""The extended Olken join-size bound (paper §3.2).

Port copy of ``repro.core.size_estimation.olken_bound`` (no predicates in
this slice): ``|J| <= |R_1| * prod_i M_{A_i}(R_{i+1})`` generalised to trees
and cyclic joins as the product of per-edge max degrees.
"""

from __future__ import annotations

from .index import Catalog
from .joins import JoinSpec


def olken_bound(cat: Catalog, spec: JoinSpec) -> float:
    """Extended Olken upper bound on |J|."""
    order = spec.expansion_order()
    b = float(order[0].relation.nrows)
    for n in order[1:]:
        idx = cat.index(n.relation, list(n.edge_attrs))
        b *= max(idx.max_degree(), 0)
    return b
