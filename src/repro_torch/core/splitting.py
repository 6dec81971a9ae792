"""§5.2 splitting + §8.1 standard templates.

The HISTOGRAM-BASED overlap estimator needs every join in ``Δ`` rewritten as an
*equi-length chain of 2-attribute sub-relations over the same template* so the
per-position degree statistics are comparable across joins (§5.1).  A template
is an ordering ``A_1 … A_k`` of the shared output attributes; join ``J`` is
split into pairs ``S_i = π_{A_i,A_{i+1}}(R)`` where ``R`` is a base relation of
``J`` containing both attributes.  Edges between consecutive pairs drawn from
the *same* base relation are **fake joins** (row identity ⇒ multiplier 1);
edges between pairs from different relations are real (multiplier = max/avg
degree of the shared attribute, Theorem 4).

Template heuristic (§8.1 / extended version): keep attributes that co-occur in
base relations adjacent — build the attribute co-occurrence graph and grow a
path greedily by strongest co-occurrence with the current endpoint (this
minimises the total pairwise distance objective the paper formulates).  When a
pair is not co-located in any base relation of some join, the sound fallback
multiplies the max degrees along the shortest connecting path in the join
(documented in DESIGN.md §7) — every multiplier stays an upper bound.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .joins import JoinSpec


@dataclasses.dataclass
class SplitPair:
    attrs: Tuple[str, str]
    source_alias: Optional[str]        # None => not co-located (path fallback)
    fake_edge_to_prev: bool            # same source as previous pair?
    path_aliases: Tuple[str, ...] = () # fallback path (for multiplier product)


@dataclasses.dataclass
class SplitPlan:
    join: JoinSpec
    template: Tuple[str, ...]
    pairs: List[SplitPair]


def _cooccurrence(joins: Sequence[JoinSpec]) -> Dict[Tuple[str, str], int]:
    co: Dict[Tuple[str, str], int] = {}
    for j in joins:
        for n in j.nodes:
            attrs = n.relation.attrs
            for i, a in enumerate(attrs):
                for b in attrs[i + 1:]:
                    k = (a, b) if a < b else (b, a)
                    co[k] = co.get(k, 0) + 1
    return co


def build_template(joins: Sequence[JoinSpec]) -> Tuple[str, ...]:
    """Greedy max-co-occurrence path over the shared output schema."""
    attrs = list(joins[0].output_attrs)
    co = _cooccurrence(joins)

    def w(a: str, b: str) -> int:
        return co.get((a, b) if a < b else (b, a), 0)

    # start from the endpoint of the strongest co-occurring pair
    best_pair = max(
        ((a, b) for i, a in enumerate(attrs) for b in attrs[i + 1:]),
        key=lambda p: w(*p),
        default=None,
    )
    if best_pair is None:
        return tuple(attrs)
    order = [best_pair[0], best_pair[1]]
    remaining = [a for a in attrs if a not in order]
    while remaining:
        tail = order[-1]
        head = order[0]
        best_tail = max(remaining, key=lambda a: w(tail, a))
        best_head = max(remaining, key=lambda a: w(head, a))
        if w(tail, best_tail) >= w(head, best_head):
            order.append(best_tail)
            remaining.remove(best_tail)
        else:
            order.insert(0, best_head)
            remaining.remove(best_head)
    return tuple(order)


def _path_between(spec: JoinSpec, a: str, b: str) -> Tuple[str, ...]:
    """Aliases on the tree path between a relation holding ``a`` and one holding ``b``."""
    holders_a = [n.alias for n in spec.nodes if a in n.relation.attrs]
    holders_b = [n.alias for n in spec.nodes if b in n.relation.attrs]
    # BFS over the tree (+ residual edges treated as links to all earlier nodes)
    parent_of: Dict[str, Optional[str]] = {}
    adj: Dict[str, List[str]] = {n.alias: [] for n in spec.nodes}
    for n in spec.tree_nodes:
        if n.parent is not None:
            adj[n.alias].append(n.parent)
            adj[n.parent].append(n.alias)
    for n in spec.residual_nodes:
        for m in spec.nodes:
            if m.alias != n.alias and set(n.edge_attrs) & set(m.relation.attrs):
                adj[n.alias].append(m.alias)
                adj[m.alias].append(n.alias)
    start = holders_a[0]
    frontier = [start]
    parent_of[start] = None
    while frontier:
        x = frontier.pop(0)
        if x in holders_b:
            path = [x]
            while parent_of[path[-1]] is not None:
                path.append(parent_of[path[-1]])
            return tuple(reversed(path))
        for y in adj[x]:
            if y not in parent_of:
                parent_of[y] = x
                frontier.append(y)
    return (start,)


def split_join(spec: JoinSpec, template: Sequence[str]) -> SplitPlan:
    template = tuple(template)
    pairs: List[SplitPair] = []
    prev_source: Optional[str] = None
    for i in range(len(template) - 1):
        a, b = template[i], template[i + 1]
        holders = [n.alias for n in spec.nodes
                   if a in n.relation.attrs and b in n.relation.attrs]
        if holders:
            # prefer the previous source (=> fake edge, multiplier 1)
            src = prev_source if prev_source in holders else holders[0]
            pairs.append(SplitPair((a, b), src, fake_edge_to_prev=(src == prev_source)))
            prev_source = src
        else:
            path = _path_between(spec, a, b)
            pairs.append(SplitPair((a, b), None, False, path_aliases=path))
            prev_source = None
    return SplitPlan(spec, template, pairs)


def split_plans(joins: Sequence[JoinSpec],
                template: Optional[Sequence[str]] = None) -> List[SplitPlan]:
    tpl = tuple(template) if template is not None else build_template(joins)
    return [split_join(j, tpl) for j in joins]
