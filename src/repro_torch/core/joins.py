"""Join specifications: chain, acyclic (tree), and cyclic joins.

Port copy of ``repro.core.joins``, §8.3 predicate provenance included.  A
join is an ordered list of
:class:`JoinNode`.  Tree nodes reference a parent node and equi-join it on
``edge_attrs`` (attribute names are standardised across relations).  Cyclic
joins are an acyclic *skeleton* tree plus *residual* nodes whose edge
attributes may span several earlier relations (§8.2).

All joins keep their full concatenated output schema (every base attribute
survives; join attributes appear once), which is what makes the batched
membership probes exact.  ``full_join`` materialises the result with
vectorised sorted-index expansion — the FULLJOIN baseline, used by the exact
warm-up and the tests, not by the samplers; it applies ``reject_preds``, as
does :func:`join_size`.  Each ``full_join`` is the span
``warmup.materialise``, and the rows each expansion step of ``full_join`` and
``join_size`` builds add to the registry counter
``repro_warmup_rows_materialised_total{join}`` (unless ``REPRO_OBS=off``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from .index import Catalog, as_tuple, query_keys
from .relation import Relation


@dataclasses.dataclass
class JoinNode:
    alias: str
    relation: Relation
    parent: Optional[str]            # alias of parent (tree nodes); None for root
    edge_attrs: Tuple[str, ...]      # equi-join attributes shared with parent/earlier output
    kind: str = "tree"               # "tree" (incl. root) | "residual"

    def __post_init__(self) -> None:
        self.edge_attrs = as_tuple(self.edge_attrs)


class JoinSpec:
    """An ordered join over base relations (chain / acyclic / cyclic)."""

    # §8.3 predicate provenance — set by the repro_torch.core.predicates
    # helpers (class-level defaults keep hand-built specs clean):
    #  * pushed_preds / pushdown_base: filters already materialised into the
    #    nodes by pushdown(), plus the unfiltered spec they came from — the
    #    device engine rebuilds the filtered join as validity masks over the
    #    base relations from these.
    #  * reject_preds: sampler-side per-join rejection predicates — samplers
    #    reject failing candidates, membership/size estimation apply them, so
    #    the filtered join is the set-union member everywhere.
    pushed_preds: Tuple = ()
    pushdown_base: Optional["JoinSpec"] = None
    reject_preds: Tuple = ()

    def __init__(self, name: str, nodes: Sequence[JoinNode]):
        self.name = name
        self.nodes: List[JoinNode] = list(nodes)
        if not self.nodes:
            raise ValueError("empty join")
        self._by_alias = {n.alias: n for n in self.nodes}
        if len(self._by_alias) != len(self.nodes):
            raise ValueError(f"duplicate aliases in join {name!r}")
        self._validate()

    @property
    def root(self) -> JoinNode:
        roots = [n for n in self.nodes if n.kind == "tree" and n.parent is None]
        if len(roots) != 1:
            raise ValueError(f"join {self.name!r} must have exactly one tree root")
        return roots[0]

    @property
    def tree_nodes(self) -> List[JoinNode]:
        return [n for n in self.nodes if n.kind == "tree"]

    @property
    def residual_nodes(self) -> List[JoinNode]:
        return [n for n in self.nodes if n.kind == "residual"]

    @property
    def is_cyclic(self) -> bool:
        return bool(self.residual_nodes)

    @property
    def is_chain(self) -> bool:
        if self.is_cyclic:
            return False
        kids = self.children_map()
        return all(len(kids.get(n.alias, [])) <= 1 for n in self.tree_nodes)

    def node(self, alias: str) -> JoinNode:
        return self._by_alias[alias]

    def children_map(self) -> Dict[str, List[JoinNode]]:
        out: Dict[str, List[JoinNode]] = {}
        for n in self.tree_nodes:
            if n.parent is not None:
                out.setdefault(n.parent, []).append(n)
        return out

    @property
    def output_attrs(self) -> List[str]:
        seen: List[str] = []
        for n in self.nodes:
            for a in n.relation.attrs:
                if a not in seen:
                    seen.append(a)
        return seen

    def _validate(self) -> None:
        produced: set = set()
        for i, n in enumerate(self.expansion_order()):
            if i == 0:
                if n.parent is not None or n.kind != "tree":
                    raise ValueError("first node in expansion order must be the root")
            else:
                missing = [a for a in n.edge_attrs if a not in produced]
                if missing:
                    raise ValueError(
                        f"join {self.name!r}: node {n.alias!r} edge attrs {missing} "
                        f"not produced by earlier nodes")
                if not n.edge_attrs:
                    raise ValueError(f"join {self.name!r}: node {n.alias!r} has no edge attrs")
                if n.kind == "tree":
                    parent_attrs = set(self._by_alias[n.parent].relation.attrs)
                    bad = [a for a in n.edge_attrs if a not in parent_attrs]
                    if bad:
                        raise ValueError(
                            f"join {self.name!r}: tree node {n.alias!r} edge attrs {bad} "
                            f"missing from parent {n.parent!r}")
                missing_child = [a for a in n.edge_attrs if a not in n.relation.attrs]
                if missing_child:
                    raise ValueError(
                        f"join {self.name!r}: node {n.alias!r} lacks its edge attrs {missing_child}")
            produced.update(n.relation.attrs)

    def expansion_order(self) -> List[JoinNode]:
        """Root-first order: parents before children, residuals last."""
        order: List[JoinNode] = []
        remaining = {n.alias: n for n in self.tree_nodes}
        frontier = [n for n in self.tree_nodes if n.parent is None]
        while frontier:
            n = frontier.pop(0)
            order.append(n)
            remaining.pop(n.alias, None)
            frontier.extend([c for c in self.tree_nodes if c.parent == n.alias])
        if remaining:
            raise ValueError(f"join {self.name!r}: disconnected tree nodes {list(remaining)}")
        order.extend(self.residual_nodes)
        return order

    def __repr__(self) -> str:  # pragma: no cover
        parts = [f"{n.alias}({'root' if n.parent is None and n.kind=='tree' else ','.join(n.edge_attrs)})"
                 for n in self.nodes]
        return f"JoinSpec({self.name!r}: {' ⋈ '.join(parts)})"


def chain_join(name: str, relations: Sequence[Relation],
               edge_attrs: Sequence[Sequence[str] | str]) -> JoinSpec:
    """R1 ⋈_{e1} R2 ⋈_{e2} ... ⋈_{e_{m-1}} Rm."""
    if len(edge_attrs) != len(relations) - 1:
        raise ValueError("need len(relations)-1 edge attr sets")
    nodes = [JoinNode(relations[0].name, relations[0], None, ())]
    for i, rel in enumerate(relations[1:]):
        ea = edge_attrs[i]
        ea = (ea,) if isinstance(ea, str) else tuple(ea)
        nodes.append(JoinNode(rel.name, rel, nodes[i].alias, ea))
    return JoinSpec(name, nodes)


ROWS_MATERIALISED = "repro_warmup_rows_materialised_total"


def _rows_built(spec: JoinSpec, rows: int) -> None:
    """Add one expansion step's rows to the join's registry counter."""
    if obs.enabled():
        obs.get_registry().counter(
            ROWS_MATERIALISED, "rows built by the host's join expansions",
            ("join",)).labels(join=spec.name).inc(rows)


def _expand(cat: Catalog, inter: Dict[str, np.ndarray], child: Relation,
            edge_attrs: Tuple[str, ...]) -> Dict[str, np.ndarray]:
    """inter ⋈ child on edge_attrs, vectorised via the child's sorted index."""
    idx = cat.index(child, list(edge_attrs))
    n = next(iter(inter.values())).shape[0] if inter else 0
    lo, hi = idx.ranges(query_keys(idx, [inter[a] for a in edge_attrs]))
    counts = hi - lo
    total = int(counts.sum())
    rep = np.repeat(np.arange(n), counts)
    starts = np.zeros(n, dtype=np.int64)
    if n > 1:
        np.cumsum(counts[:-1], out=starts[1:])
    within = np.arange(total, dtype=np.int64) - np.repeat(starts, counts)
    child_rows = idx.row_ids_at(lo[rep] + within)
    out = {a: c[rep] for a, c in inter.items()}
    for a in child.attrs:
        if a not in out:
            out[a] = child.columns[a][child_rows]
    return out


def full_join(cat: Catalog, spec: JoinSpec) -> Dict[str, np.ndarray]:
    """Materialise the join result (the expensive FULLJOIN baseline).

    ``reject_preds`` (if any) are applied to the output — the filtered join
    is the member of the union, so exact baselines must count it.
    """
    with obs.span("warmup.materialise"):
        return _full_join(cat, spec)


def _full_join(cat: Catalog, spec: JoinSpec) -> Dict[str, np.ndarray]:
    order = spec.expansion_order()
    inter: Dict[str, np.ndarray] = {a: c.copy()
                                    for a, c in order[0].relation.columns.items()}
    for n in order[1:]:
        inter = _expand(cat, inter, n.relation, n.edge_attrs)
        _rows_built(spec, next(iter(inter.values())).shape[0])
    if spec.reject_preds:
        n_rows = next(iter(inter.values())).shape[0] if inter else 0
        keep = np.ones(n_rows, dtype=bool)
        for p in spec.reject_preds:
            keep &= p.mask(inter)
        inter = {a: c[keep] for a, c in inter.items()}
    return inter


def full_join_matrix(cat: Catalog, spec: JoinSpec,
                     attrs: Optional[Sequence[str]] = None) -> np.ndarray:
    """(n, k) value matrix of the full join over ``attrs`` (default: output schema)."""
    res = full_join(cat, spec)
    attrs = list(attrs) if attrs is not None else spec.output_attrs
    n = next(iter(res.values())).shape[0] if res else 0
    if n == 0:
        return np.zeros((0, len(attrs)), dtype=np.int64)
    return np.stack([res[a] for a in attrs], axis=1)


def join_size(cat: Catalog, spec: JoinSpec) -> int:
    """|J| without materialising attribute payloads (counts only)."""
    if spec.reject_preds:
        # predicate columns must be materialised to count survivors
        res = full_join(cat, spec)
        return int(next(iter(res.values())).shape[0]) if res else 0
    order = spec.expansion_order()
    inter: Dict[str, np.ndarray] = dict(order[0].relation.columns)
    count_weight = np.ones(order[0].relation.nrows, dtype=np.int64)
    for i, n in enumerate(order[1:], start=1):
        idx = cat.index(n.relation, list(n.edge_attrs))
        lo, hi = idx.ranges(query_keys(idx, [inter[a] for a in n.edge_attrs]))
        counts = hi - lo
        # expand only when this child brings attributes a later edge keys on
        later_needed = set()
        for m in order[i + 1:]:
            later_needed.update(m.edge_attrs)
        new_attrs = [a for a in n.relation.attrs if a not in inter]
        if any(a in later_needed for a in new_attrs):
            inter = _expand(cat, inter, n.relation, n.edge_attrs)
            count_weight = np.repeat(count_weight, counts)
        else:
            keep = counts > 0
            count_weight = count_weight[keep] * counts[keep]
            inter = {a: c[keep] for a, c in inter.items()}
        _rows_built(spec, count_weight.shape[0])
    return int(count_weight.sum())
