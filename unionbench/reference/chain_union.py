"""Plain numpy reference for a union of chain joins over shared base rows.

Every join of a :class:`unionbench.inputs.Union` follows one chain of base
relations (the same relations and edges for every join) and keeps a
subset of each relation's rows (its variant mask, AND its pushdown
predicates evaluated here on the relation's own columns).  Every relation
holds its primary key, so an output tuple fixes its base rows: a tuple
lies in a join iff each of its base rows is kept by that join, and the
intersection of several joins is the chain over the AND of their masks.
From that alone this module works out

* the exact size of every join and intersection, and so of every cover
  piece ``J'_k = J_k \\ (J_0 ∪ … ∪ J_{k-1})`` (inclusion-exclusion);
* how many tuples of a piece pass through each row of each node (the
  exact marginal law of a uniform sample of the piece);
* for served rows, the base row of each node (by primary key, every
  column compared) and so membership in every join;
* uniform samples of the union by Algorithm 1 (:meth:`ChainUnion.sample`),
  which the control runs with every weight it computes rounded to
  bfloat16.

:func:`reference` is the module's entry (the interface the judge reads is
:class:`unionbench.reference.judge.Reference`).  It imports nothing of the
program and nothing but numpy.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_OPS = {
    "==": np.equal, "!=": np.not_equal, "<": np.less, "<=": np.less_equal,
    ">": np.greater, ">=": np.greater_equal,
    "in": lambda c, v: np.isin(c, np.fromiter(v, np.int64)),
}


def bf16(x: np.ndarray) -> np.ndarray:
    """Round to the nearest bfloat16 (ties to even), back in float64."""
    b = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32).astype(np.float64)


def _exact(x: np.ndarray) -> np.ndarray:
    return x


def _pack(cols: Sequence[np.ndarray], radices: Sequence[int]) -> np.ndarray:
    out = np.zeros(cols[0].shape[0], dtype=np.int64)
    for c, r in zip(cols, radices):
        out = out * np.int64(r) + c
    return out


def reference(union, precision: str = "f64") -> "ChainUnion":
    """The reference of ``union``, whose joins must be chains over the same
    relations and edges; ``precision="bf16"`` is the control."""
    shape = _shape_error(union)
    if shape:
        raise ValueError(f"chain_union judges unions of chain joins over one "
                         f"chain; {shape}")
    return ChainUnion(union, precision)


def _shape_error(union) -> str:
    """What keeps ``union`` from being one shared chain ('' if nothing)."""
    first = [(n.relation, n.edge) for n in union.nodes(0)]
    for k, j in enumerate(union.joins):
        nodes = union.nodes(k)
        kids: Dict[str, int] = {}
        for n in nodes:
            if n.kind == "residual":
                return (f"join {j.name!r} is cyclic: node {n.relation!r} is a "
                        f"residual on {n.edge}")
            kids[n.parent] = kids.get(n.parent, 0) + 1
        wide = [p for p, c in kids.items() if p is not None and c > 1]
        if wide:
            return (f"join {j.name!r} is a branching tree: node {wide[0]!r} "
                    f"has {kids[wide[0]]} children")
        if not union.is_chain(k):
            return (f"join {j.name!r} is a chain out of node order: its "
                    f"parents are {[n.parent for n in nodes]}")
        if [(n.relation, n.edge) for n in nodes] != first:
            return (f"join {j.name!r} follows another chain than "
                    f"{union.joins[0].name!r}: {[n.relation for n in nodes]}")
    return ""


class ChainUnion:
    """Exact sizes, marginals and membership of a union of chain joins.

    ``precision="bf16"`` rounds every weight, size and cumulative sum that
    it computes to bfloat16 (the control); ``"f64"`` is exact."""

    def __init__(self, union, precision: str = "f64"):
        if precision not in ("f64", "bf16"):
            raise ValueError(f"precision {precision!r}")
        self.union = union
        self.rnd = bf16 if precision == "bf16" else _exact
        chain = union.nodes(0)
        self.rels = [node.relation for node in chain]
        self.cols = [union.relations[r] for r in self.rels]
        self.nrows = [len(next(iter(c.values()))) for c in self.cols]
        # per edge i (node i -> node i+1): dense key ids of both sides
        self.parent_kid: List[np.ndarray] = []
        self.child_kid: List[np.ndarray] = []
        self.nkeys: List[int] = []
        for i, node in enumerate(chain[1:]):
            a, b = self.cols[i], self.cols[i + 1]
            pa = [a[x] for x in node.edge]
            ch = [b[x] for x in node.edge]
            radices = [int(max(p.max(initial=0), c.max(initial=0))) + 1
                       for p, c in zip(pa, ch)]
            pk, ck = _pack(pa, radices), _pack(ch, radices)
            if int(np.prod(radices, dtype=np.float64)) <= 1 << 26:
                n = int(np.prod(radices))
            else:
                uni, inv = np.unique(np.concatenate([pk, ck]), return_inverse=True)
                pk, ck, n = inv[:pk.size], inv[pk.size:], uni.size
            self.parent_kid.append(pk)
            self.child_kid.append(ck)
            self.nkeys.append(n)
        # join masks over the base rows: variant AND pushdown predicates
        self.masks: List[List[np.ndarray]] = []
        for j in union.joins:
            per = []
            for rel, cols, n in zip(self.rels, self.cols, self.nrows):
                m = j.masks.get(rel)
                m = np.ones(n, bool) if m is None else np.asarray(m, bool).copy()
                for attr, op, value in j.preds:
                    if attr in cols:
                        m &= _OPS[op](cols[attr], value)
                per.append(m)
            self.masks.append(per)
        self._pieces: Optional[Tuple[np.ndarray, List[List[np.ndarray]]]] = None
        self._sorted: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._locate: Dict[int, Tuple[np.ndarray, np.ndarray, List[int]]] = {}
        self._located: Tuple = (None, None)

    # ------------------------------------------------- the judge's interface
    def nodes(self, k: int) -> List[str]:
        return self.rels

    def node_rows(self, k: int) -> List[int]:
        return self.nrows

    def locate(self, rows: Dict[str, np.ndarray], k: int) -> np.ndarray:
        """(n, nodes) base row of each node for each served row, -1 where
        the relation holds no row equal to the row's projection (every
        join has the same nodes).  The last mapping located is kept, so
        that :meth:`member` on it (not changed since) locates nothing
        again."""
        if self._located[0] is not rows:
            self._located = (rows, self._locate_rows(rows))
        return self._located[1]

    def member(self, rows: Dict[str, np.ndarray], q: int) -> np.ndarray:
        """Whether each served row is a tuple of join ``q``."""
        return self.member_ids(self.locate(rows, q), q)

    # ----------------------------------------------------------- counting
    def _and_masks(self, members: Sequence[int]) -> List[np.ndarray]:
        out = [m.copy() for m in self.masks[members[0]]]
        for j in members[1:]:
            for p, m in enumerate(self.masks[j]):
                out[p] &= m
        return out

    def down(self, masks: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Per node, the tuples of the chain's rest below each row."""
        r = self.rnd
        m = len(masks)
        d: List[Optional[np.ndarray]] = [None] * m
        d[-1] = masks[-1].astype(np.float64)
        for i in range(m - 2, -1, -1):
            agg = r(np.bincount(self.child_kid[i], weights=d[i + 1],
                                minlength=self.nkeys[i]))
            d[i] = r(masks[i] * agg[self.parent_kid[i]])
        return d

    def through(self, masks: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Per node, the chain's tuples that pass through each row."""
        d = self.down(masks)
        up = np.ones(self.nrows[0])
        out = [up * d[0]]
        for i in range(len(masks) - 1):
            agg = np.bincount(self.parent_kid[i], weights=up * masks[i],
                              minlength=self.nkeys[i])
            up = agg[self.child_kid[i]]
            out.append(up * d[i + 1])
        return out

    def size(self, members: Sequence[int]) -> float:
        return float(self.rnd(np.asarray([self.down(self._and_masks(members))[0].sum()]))[0])

    def pieces(self) -> Tuple[np.ndarray, List[List[np.ndarray]]]:
        """Exact piece sizes in cover order, and per piece and node the
        piece's tuples through each row (inclusion-exclusion over the
        earlier joins)."""
        if self._pieces is None:
            sizes, marg = [], []
            for k in range(len(self.masks)):
                acc = [np.zeros(n) for n in self.nrows]
                for m in range(k + 1):
                    for sub in itertools.combinations(range(k), m):
                        t = self.through(self._and_masks((k,) + sub))
                        sign = -1.0 if m % 2 else 1.0
                        for p in range(len(acc)):
                            acc[p] += sign * t[p]
                marg.append(acc)
                sizes.append(max(float(acc[0].sum()), 0.0))
            self._pieces = (np.asarray(sizes), marg)
        return self._pieces

    def piece_sizes_rounded(self) -> np.ndarray:
        """Piece sizes by inclusion-exclusion over rounded join and
        intersection sizes, each partial sum rounded (the control's)."""
        out = []
        for k in range(len(self.masks)):
            v = self.size((k,))
            for m in range(1, k + 1):
                for sub in itertools.combinations(range(k), m):
                    s = self.size((k,) + sub)
                    v = float(self.rnd(np.asarray([v + (-s if m % 2 else s)]))[0])
            out.append(max(v, 0.0))
        return np.asarray(out)

    # ---------------------------------------------------------- membership
    def _key_index(self, p: int):
        if p not in self._locate:
            rel = self.rels[p]
            pk = self.union.keys[rel]
            cols = self.cols[p]
            radices = [int(cols[a].max(initial=0)) + 1 for a in pk]
            key = _pack([cols[a] for a in pk], radices)
            order = np.argsort(key, kind="stable")
            self._locate[p] = (key[order], order, radices)
        return self._locate[p]

    def _locate_rows(self, rows: Dict[str, np.ndarray]) -> np.ndarray:
        n = len(next(iter(rows.values())))
        ids = np.full((n, len(self.rels)), -1, dtype=np.int64)
        for p, rel in enumerate(self.rels):
            cols = self.cols[p]
            skey, order, radices = self._key_index(p)
            pk = self.union.keys[rel]
            q = [np.asarray(rows[a], np.int64) for a in pk]
            inside = np.ones(n, bool)
            for c, r in zip(q, radices):
                inside &= (c >= 0) & (c < r)
            qk = _pack([np.where(inside, c, 0) for c in q], radices)
            pos = np.minimum(np.searchsorted(skey, qk), skey.size - 1)
            hit = inside & (skey[pos] == qk)
            row = np.where(hit, order[pos], 0)
            for a, c in cols.items():
                hit &= c[row] == np.asarray(rows[a], np.int64)
            ids[:, p] = np.where(hit, row, -1)
        return ids

    def member_ids(self, ids: np.ndarray, j: int) -> np.ndarray:
        """Whether each located row is a tuple of join ``j``."""
        ok = (ids >= 0).all(axis=1)
        safe = np.where(ids >= 0, ids, 0)
        for p, m in enumerate(self.masks[j]):
            ok &= m[safe[:, p]]
        return ok

    def rows_of(self, ids: np.ndarray) -> Dict[str, np.ndarray]:
        out: Dict[str, np.ndarray] = {}
        for p, cols in enumerate(self.cols):
            for a, c in cols.items():
                out.setdefault(a, c[ids[:, p]])
        return out

    # ------------------------------------------------------------ sampling
    def _sorted_child(self, i: int):
        """Rows of node i+1 in key order, key range starts, cumulative
        weights per join (cached per join)."""
        if i not in self._sorted:
            kid = self.child_kid[i]
            order = np.argsort(kid, kind="stable")
            starts = np.concatenate([[0], np.cumsum(np.bincount(
                kid, minlength=self.nkeys[i]))])
            self._sorted[i] = (order, starts)
        return self._sorted[i]

    def _pick(self, cum: np.ndarray, lo: np.ndarray, hi: np.ndarray,
              u: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Inverse-CDF pick in ``[lo, hi)`` over the cumulative weights
        ``cum`` taken from ``lo`` (rounded as the precision says): the
        first position whose cumulative weight exceeds ``u`` times the
        range's total.  Returns the position and whether it had weight."""
        r = self.rnd
        base = np.where(lo > 0, cum[np.maximum(lo - 1, 0)], 0.0)
        last = np.maximum(hi - 1, 0)
        total = np.where(hi > lo, r(cum[last] - base), 0.0)
        target = u * total
        a, b = lo.copy(), hi.copy()
        while True:
            act = a < b
            if not act.any():
                break
            mid = (a + b) // 2
            val = r(cum[np.minimum(mid, cum.size - 1)] - base)
            right = act & (val <= target)
            left = act & ~right
            a = np.where(right, mid + 1, a)
            b = np.where(left, mid, b)
        return a, (total > 0) & (a < hi)

    def _draw(self, k: int, d: List[np.ndarray], cums, count: int,
              rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
        """``count`` candidates of join ``k`` (EW): base row ids per node
        and whether the walk found weight at every hop."""
        m = len(self.rels)
        ids = np.zeros((count, m), dtype=np.int64)
        u = rng.random((m, count))
        root_cum = cums[0]
        zero = np.zeros(count, dtype=np.int64)
        pos, ok = self._pick(root_cum, zero, zero + root_cum.size, u[0])
        ids[:, 0] = np.minimum(pos, self.nrows[0] - 1)
        for i in range(m - 1):
            order, starts = self._sorted_child(i)
            key = self.parent_kid[i][ids[:, i]]
            pos, alive = self._pick(cums[i + 1], starts[key], starts[key + 1], u[i + 1])
            ok &= alive
            ids[:, i + 1] = order[np.minimum(pos, order.size - 1)]
        return ids, ok

    def sampler_state(self):
        """Per join: down weights and cumulative weights in the order the
        picks read them (root rows in row order, others in key order); a
        pick rounds the cumulative weights it reads, taken from the start
        of its range."""
        state = []
        for k in range(len(self.masks)):
            d = self.down(self.masks[k])
            cums = [np.cumsum(d[0])]
            for i in range(len(d) - 1):
                order, _ = self._sorted_child(i)
                cums.append(np.cumsum(d[i + 1][order]))
            state.append((d, cums))
        return state

    def sample(self, n: int, rng: np.random.Generator, state=None,
               sizes: Optional[np.ndarray] = None, stall: int = 200
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Algorithm 1: ``n`` samples of the union, as (base ids, home).
        A piece is chosen with probability ``|J'_k| / Σ|J'|`` and a join's
        candidates are drawn until one lies in no earlier join.  A piece
        whose candidates all fail ``stall`` times in a row gives up its
        slots, which are left out (so a rounded law that gives weight to an
        empty piece returns fewer rows than asked)."""
        state = state if state is not None else self.sampler_state()
        if sizes is None:
            sizes = (self.pieces()[0] if self.rnd is _exact
                     else self.piece_sizes_rounded())
        cum = self.rnd(np.cumsum(sizes))
        sel = np.searchsorted(cum, rng.random(n) * cum[-1], side="right")
        sel = np.minimum(sel, len(sizes) - 1)
        ids = np.zeros((n, len(self.rels)), dtype=np.int64)
        filled = np.zeros(n, dtype=bool)
        for k in range(len(sizes)):
            want = np.flatnonzero(sel == k)
            got, idle = 0, 0
            while got < want.size and idle < stall:
                need = want.size - got
                cand, ok = self._draw(k, *state[k], max(need, 64), rng)
                for q in range(k):
                    ok &= ~self.member_ids(cand, q)
                cand = cand[ok][:need]
                idle = 0 if cand.shape[0] else idle + 1
                ids[want[got:got + cand.shape[0]]] = cand
                filled[want[got:got + cand.shape[0]]] = True
                got += cand.shape[0]
        return ids[filled], sel[filled].astype(np.int64)
