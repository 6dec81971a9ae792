"""Plain numpy reference for a union of joins that each have an anchor: a
node from which every other node is reached through that node's primary
key (TPC-H Q5's skeleton from lineitem, and its §8.2 residual).

Every join of the :class:`unionbench.inputs.Union` has the same nodes (the
same relations, edges, parents and kinds) and keeps its own subset of each
relation's rows (variant masks AND pushdown predicates).  In each join
one node, the anchor, reaches every other node through that node's
primary key: across a tree edge whose attributes hold the other node's
key, or, for a residual node, by a lookup of its key among its edge
attributes.  So every anchor row fixes at most one row of each node, and
each tuple of a join is fixed by one anchor row, whose primary key is in
the output.  A tuple therefore lies in a join iff its anchor row does:
every row it reaches exists and is kept by the join, and every attribute
that several nodes hold agrees (the tree edges' attributes and the
residual's).  Tuple identity across joins is anchor-row identity.  From
that, with vectorised key lookups over the anchor rows and nothing
materialised as sets, this module works out

* the exact size of every cover piece ``J'_k = J_k \\ (J_0 ∪ … ∪
  J_{k-1})`` (boolean differences over anchor rows, in cover order) and
  each piece's marginal at every node;
* for served rows, the base row of each node (by primary key, every column
  compared) and so membership in every join;
* samples of the union (:meth:`AnchoredUnion.sample`), which the control
  draws as the program does with every weight, size and cumulative sum
  rounded to bfloat16: the skeleton walk (exact weights, a weighted pick
  per tree node), the residual test, then the cover's rejection.

:func:`reference` is the module's entry (the interface the judge reads is
:class:`unionbench.reference.judge.Reference`); any other shape is refused
with a message that names it.  It imports nothing of the program and
nothing but numpy.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .chain_union import _OPS, _exact, bf16


def reference(union, precision: str = "f64") -> "AnchoredUnion":
    """The reference of ``union``, whose joins must share one node list
    with an anchor; ``precision="bf16"`` is the control."""
    anchor, shape = _anchor(union)
    if shape:
        raise ValueError("anchored_union judges unions of joins over one node "
                         f"list with an anchor node; {shape}")
    return AnchoredUnion(union, anchor, precision)


def _signature(union, k: int):
    return [(n.relation, n.edge, n.parent, n.kind) for n in union.nodes(k)]


def _reach(union, nodes, anchor: int) -> Tuple[list, str]:
    """From node ``anchor``, the lookups that reach the other nodes, each
    ``(from, to)`` (``from`` None: a residual, keyed by the tuple's
    values), and what keeps a node from being reached ('' if nothing)."""
    keys = union.keys
    edges = [(n.parent, n.relation, n.edge) for n in nodes
             if n.kind == "tree" and n.parent is not None]
    at = {n.relation: i for i, n in enumerate(nodes)}
    steps, seen, frontier = [], {nodes[anchor].relation}, [nodes[anchor].relation]
    blocked = []
    while frontier:
        u = frontier.pop(0)
        for a, b, e in edges:
            v = b if u == a else a if u == b else None
            if v is None or v in seen:
                continue
            if set(keys[v]) <= set(e):
                seen.add(v)
                frontier.append(v)
                steps.append((at[u], at[v]))
            else:
                blocked.append((v, f"{v!r} is joined to {u!r} on {e}, not "
                                   f"on its key {keys[v]}"))
    for n in nodes:
        if n.kind != "residual":
            continue
        if set(keys[n.relation]) <= set(n.edge):
            seen.add(n.relation)
            steps.append((None, at[n.relation]))
        else:
            blocked.append((n.relation, f"residual {n.relation!r} is joined "
                                        f"on {n.edge}, which lacks its key "
                                        f"{keys[n.relation]}"))
    missing = [why for v, why in blocked if v not in seen]
    return steps, missing[0] if missing else ""


def _anchor(union) -> Tuple[Optional[Tuple[int, list]], str]:
    """(anchor node, its lookups), or what keeps ``union`` from having one."""
    first = _signature(union, 0)
    for k, j in enumerate(union.joins):
        if _signature(union, k) != first:
            return None, (f"join {j.name!r} has other nodes than "
                          f"{union.joins[0].name!r}: "
                          f"{[n.relation for n in union.nodes(k)]}")
    nodes = union.nodes(0)
    why = []
    for i, n in enumerate(nodes):
        if n.kind != "tree":
            continue
        steps, missing = _reach(union, nodes, i)
        if not missing:
            return (i, steps), ""
        why.append((len(steps), n.relation, missing))
    reached, rel, missing = max(why)
    return None, (f"join {union.joins[0].name!r} has no anchor: no node "
                  f"reaches every other through primary keys (from {rel!r}, "
                  f"{missing})")


def _domain(cols: Sequence[np.ndarray]) -> Tuple[List[int], List[int]]:
    """Each column's least value (at most 0) and width, for packing."""
    lo = [int(np.asarray(c).min(initial=0)) for c in cols]
    widths = [int(np.asarray(c).max(initial=0)) - m + 1 for c, m in zip(cols, lo)]
    if np.prod(widths, dtype=np.float64) >= 2.0 ** 62:
        raise ValueError(f"a key of {len(cols)} columns does not pack into "
                         "62 bits")
    return lo, widths


def _pack(cols: Sequence[np.ndarray], lo: Sequence[int],
          widths: Sequence[int]) -> np.ndarray:
    out = np.zeros(np.asarray(cols[0]).shape[0], np.int64)
    for c, m, w in zip(cols, lo, widths):
        out = out * np.int64(w) + (np.asarray(c, np.int64) - m)
    return out


class _KeyIndex:
    """Rows of a relation sorted by a packed key over ``attrs``."""

    def __init__(self, cols: Dict[str, np.ndarray], attrs: Sequence[str]):
        own = [cols[a] for a in attrs]
        self.lo, self.widths = _domain(own)
        key = _pack(own, self.lo, self.widths)
        self.order = np.argsort(key, kind="stable")
        self.sorted = key[self.order]

    def find(self, cols: Sequence[np.ndarray]) -> np.ndarray:
        """The row whose key equals each query's, -1 where none does."""
        n = np.asarray(cols[0]).shape[0]
        if self.sorted.size == 0:
            return np.full(n, -1, np.int64)
        inside = np.ones(n, bool)
        for c, m, w in zip(cols, self.lo, self.widths):
            c = np.asarray(c, np.int64)
            inside &= (c >= m) & (c < m + w)
        q = _pack([np.where(inside, c, m) for c, m in zip(cols, self.lo)],
                  self.lo, self.widths)
        pos = np.minimum(np.searchsorted(self.sorted, q), self.sorted.size - 1)
        hit = inside & (self.sorted[pos] == q)
        return np.where(hit, self.order[pos], -1)


class AnchoredUnion:
    """Exact piece sizes, marginals and membership of a union of anchored
    joins over one node list.

    ``precision="bf16"`` draws with every weight, size and cumulative sum
    that the skeleton walk computes rounded to bfloat16 (the control);
    ``"f64"`` is exact."""

    def __init__(self, union, anchor: Tuple[int, list], precision: str = "f64"):
        if precision not in ("f64", "bf16"):
            raise ValueError(f"precision {precision!r}")
        self.union = union
        self.rnd = bf16 if precision == "bf16" else _exact
        self.node_list = union.nodes(0)
        self.rels = [n.relation for n in self.node_list]
        self.cols = [union.relations[r] for r in self.rels]
        self.nrows = [len(next(iter(c.values()))) for c in self.cols]
        self.anchor, steps = anchor
        self._keys = [_KeyIndex(c, union.keys[r])
                      for r, c in zip(self.rels, self.cols)]
        self.table, found = self._lookups(steps)
        self.masks = [self._join_masks(j) for j in union.joins]
        self.valid = [found & self._kept(k) for k in range(len(union.joins))]
        self.piece_of = np.full(self.nrows[self.anchor], -1, np.int8)
        for k, v in enumerate(self.valid):
            self.piece_of[v & (self.piece_of < 0)] = k
        self._pieces: Optional[Tuple[np.ndarray, List[List[np.ndarray]]]] = None
        self._located: Tuple = (None, None)

    # -------------------------------------------------------- construction
    def _lookups(self, steps) -> Tuple[np.ndarray, np.ndarray]:
        """(anchor rows, nodes) row reached at each node (-1: none), and
        which anchor rows reach a row at every node whose shared
        attributes all agree."""
        n = self.nrows[self.anchor]
        ids = np.full((n, len(self.rels)), -1, np.int64)
        ids[:, self.anchor] = np.arange(n)
        tree = [p for p, node in enumerate(self.node_list) if node.kind == "tree"]
        for src, dst in steps:
            key = self.union.keys[self.rels[dst]]
            if src is None:                     # a residual: the tuple's values
                ok = (ids[:, tree] >= 0).all(axis=1)
                vals = [self._value(ids, a) for a in key]
            else:
                ok = ids[:, src] >= 0
                at = np.where(ok, ids[:, src], 0)
                vals = [self.cols[src][a][at] for a in key]
            ids[:, dst] = np.where(ok, self._keys[dst].find(vals), -1)
        found = (ids >= 0).all(axis=1)
        safe = np.where(found[:, None], ids, 0)
        for a in self._shared():
            held = [p for p, c in enumerate(self.cols) if a in c]
            v0 = self.cols[held[0]][a][safe[:, held[0]]]
            for p in held[1:]:
                found &= self.cols[p][a][safe[:, p]] == v0
        return np.where(found[:, None], ids, -1), found

    def _shared(self) -> List[str]:
        """Attributes that more than one node holds."""
        held = Counter(a for c in self.cols for a in c)
        return [a for a, m in held.items() if m > 1]

    def _value(self, ids: np.ndarray, attr: str) -> np.ndarray:
        """The tuple's value of ``attr``: the first tree node's that holds
        it."""
        p = next(p for p, c in enumerate(self.cols)
                 if attr in c and self.node_list[p].kind == "tree")
        return self.cols[p][attr][np.maximum(ids[:, p], 0)]

    def _join_masks(self, join) -> List[np.ndarray]:
        """Per node, the rows ``join`` keeps: its variant mask AND its
        pushdown predicates on the relation's own columns."""
        out = []
        for rel, cols, n in zip(self.rels, self.cols, self.nrows):
            m = join.masks.get(rel)
            m = np.ones(n, bool) if m is None else np.asarray(m, bool).copy()
            for attr, op, value in join.preds:
                if attr in cols:
                    m &= _OPS[op](cols[attr], value)
            out.append(m)
        return out

    def _kept(self, k: int) -> np.ndarray:
        safe = np.maximum(self.table, 0)
        ok = np.ones(self.table.shape[0], bool)
        for p, m in enumerate(self.masks[k]):
            ok &= m[safe[:, p]]
        return ok

    # ------------------------------------------------- the judge's interface
    def nodes(self, k: int) -> List[str]:
        return self.rels

    def node_rows(self, k: int) -> List[int]:
        return self.nrows

    def pieces(self) -> Tuple[np.ndarray, List[List[np.ndarray]]]:
        """Exact piece sizes in cover order, and per piece and node the
        piece's tuples through each row."""
        if self._pieces is None:
            sizes, marg = [], []
            for k in range(len(self.valid)):
                ids = self.table[self.piece_of == k]
                sizes.append(float(ids.shape[0]))
                marg.append([np.bincount(ids[:, p], minlength=n)
                             .astype(np.float64)
                             for p, n in enumerate(self.nrows)])
            self._pieces = (np.asarray(sizes), marg)
        return self._pieces

    def locate(self, rows: Dict[str, np.ndarray], k: int) -> np.ndarray:
        """(n, nodes) base row of each node for each served row, -1 where
        the relation holds no row equal to the row's projection.  The last
        mapping located is kept (every join has the same nodes)."""
        if self._located[0] is not rows:
            self._located = (rows, self._locate_rows(rows))
        return self._located[1]

    def member(self, rows: Dict[str, np.ndarray], q: int) -> np.ndarray:
        """Whether each served row is a tuple of join ``q``: its anchor row
        lies in the join and reaches the very rows located."""
        ids = self.locate(rows, q)
        ok = (ids >= 0).all(axis=1)
        a = np.where(ok, ids[:, self.anchor], 0)
        return ok & self.valid[q][a] & (self.table[a] == ids).all(axis=1)

    def _locate_rows(self, rows: Dict[str, np.ndarray]) -> np.ndarray:
        n = len(next(iter(rows.values())))
        ids = np.full((n, len(self.rels)), -1, np.int64)
        for p, (rel, cols) in enumerate(zip(self.rels, self.cols)):
            row = self._keys[p].find([rows[a] for a in self.union.keys[rel]])
            hit = row >= 0
            row = np.where(hit, row, 0)
            for a, c in cols.items():
                hit &= c[row] == np.asarray(rows[a], np.int64)
            ids[:, p] = np.where(hit, row, -1)
        return ids

    def rows_of(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for p, cols in enumerate(self.cols):
            for a, c in cols.items():
                out.setdefault(a, c[ids[:, p]])
        return out

    # ------------------------------------------------------------ sampling
    def _edge_keys(self, parent: int, child: int, edge) -> Tuple[np.ndarray, np.ndarray, int]:
        """Dense key ids of both sides of a tree edge, and their count."""
        both = [np.concatenate([self.cols[parent][a], self.cols[child][a]])
                for a in edge]
        lo, widths = _domain(both)
        packed = _pack(both, lo, widths)
        n = int(np.prod(widths, dtype=np.float64))
        if n > 1 << 26:
            uni, packed = np.unique(packed, return_inverse=True)
            n = uni.size
        m = self.nrows[parent]
        return packed[:m], packed[m:], n

    def walk_probability(self, k: int) -> np.ndarray:
        """Per anchor row, the probability that join ``k``'s skeleton walk
        (exact weights, a pick per tree node over the cumulative weights of
        its key range, rounded as the precision says) draws the skeleton
        tuple the row fixes (0 where the row fixes no tuple of the union,
        or one that join ``k`` does not keep).  Exact, it is one over the
        skeleton's size for every such tuple."""
        r = self.rnd
        tree = [p for p, n in enumerate(self.node_list) if n.kind == "tree"]
        at = {n.relation: p for p, n in enumerate(self.node_list)}
        kids: Dict[int, List[Tuple[int, np.ndarray, np.ndarray, int]]] = {}
        child_key: Dict[int, Tuple[np.ndarray, int]] = {}
        for p in tree[1:]:
            node = self.node_list[p]
            pk, ck, nk = self._edge_keys(at[node.parent], p, node.edge)
            kids.setdefault(at[node.parent], []).append((p, pk, ck, nk))
            child_key[p] = (ck, nk)
        # down weights: the skeleton's tuples below each row
        d: Dict[int, np.ndarray] = {}
        for p in reversed(tree):
            w = self.masks[k][p].astype(np.float64)
            for c, pk, ck, nk in kids.get(p, []):
                agg = r(np.bincount(ck, weights=d[c], minlength=nk))
                w = r(w * agg[pk])
            d[p] = w
        # each row's pick probability within its range
        pick: Dict[int, np.ndarray] = {}
        for p in tree:
            if p == tree[0]:
                key, nk = np.zeros(self.nrows[p], np.int64), 1
            else:
                key, nk = child_key[p]
            order = np.argsort(key, kind="stable")
            cum = np.cumsum(d[p][order])
            starts = np.concatenate([[0], np.cumsum(np.bincount(key, minlength=nk))])
            lo = np.repeat(starts[:-1], np.diff(starts))      # per sorted position
            hi = np.repeat(starts[1:], np.diff(starts))
            base = np.where(lo > 0, cum[np.maximum(lo - 1, 0)], 0.0)
            total = r(cum[hi - 1] - base)
            val = r(cum - base)
            prev = np.where(np.arange(cum.size) > lo,
                            np.concatenate([[0.0], val[:-1]]), 0.0)
            with np.errstate(divide="ignore", invalid="ignore"):
                share = np.where(total > 0, (val - prev) / total, 0.0)
            pick[p] = np.empty(cum.size)
            pick[p][order] = share
        safe = np.maximum(self.table, 0)
        out = (self.table[:, tree] >= 0).all(axis=1).astype(np.float64)
        for p in tree:
            out *= pick[p][safe[:, p]]
        return out

    def sample(self, n: int, rng: np.random.Generator
               ) -> Tuple[np.ndarray, np.ndarray]:
        """``n`` samples of the union, as (base ids, home).  A piece is
        chosen with probability ``|J'_k| / Σ|J'|``; within it, a tuple with
        the probability that the skeleton walk draws it, given that it
        passes the residual test and lies in no earlier join (what drawing,
        testing and rejecting until a candidate passes gives).  Exact, that
        is uniform over the piece."""
        sizes = self.pieces()[0]
        if self.rnd is not _exact:
            sizes = self.rnd(sizes)
        cum = self.rnd(np.cumsum(sizes))
        sel = np.searchsorted(cum, rng.random(n) * cum[-1], side="right")
        sel = np.minimum(sel, len(sizes) - 1)
        anchor = np.zeros(n, np.int64)
        filled = np.zeros(n, bool)
        for k in range(len(sizes)):
            want = np.flatnonzero(sel == k)
            rows = np.flatnonzero(self.piece_of == k)
            if want.size == 0 or rows.size == 0:
                continue
            if self.rnd is _exact:
                pick = rows[rng.integers(0, rows.size, want.size)]
            else:
                w = self.walk_probability(k)[rows]
                if w.sum() <= 0:
                    continue
                pick = rng.choice(rows, want.size, p=w / w.sum())
            anchor[want] = pick
            filled[want] = True
        return self.table[anchor[filled]], sel[filled].astype(np.int64)
