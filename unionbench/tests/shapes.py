"""Two tiny unions of shapes that no cell of the benchmark has, each with a
builder and a brute-force reference that the tests register under names of
their own (nothing under ``unionbench/inputs/`` or ``unionbench/reference/``
is added or edited for them):

* ``branching`` (UQ3's shape, §5.2): customer and orders, whole and split
  vertically.  ``SPLIT`` is a branching tree (``cust_a`` has two children),
  ``ORDERS_SPLIT`` a chain over whole customers and split orders, ``WHOLE``
  the plain chain; the three share one output schema.
* ``cyclic`` (TPC-H Q5's join graph, §8.2): the skeleton nation ⋈ customer
  ⋈ orders ⋈ lineitem ⋈ supplier (on ``l_suppkey``) and a residual
  (suppkey, nationkey) index that closes the cycle ``c_nationkey =
  s_nationkey``, in three variants of the data.

Joins keep variant rows (``overlap`` of the rows shared, half of the rest
each), so their tuples overlap and the cover has pieces to tell apart.

:func:`reference` materialises every join with numpy, imports nothing of
the program, and answers the judge's questions by brute force.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from unionbench.inputs import Join, Node, Union
from unionbench.inputs.tpch import generate, renamed, variant_masks

CUSTOMER = {"c_custkey": "ck", "c_nationkey": "nk"}
ORDERS = {"o_orderkey": "ok", "o_custkey": "ck"}


def build(config: dict, seed: int) -> Union:
    return {"branching": _branching, "cyclic": _cyclic}[config["shape"]](
        config, seed)


def _project(cols, attrs):
    return {a: cols[a] for a in attrs}


def _branching(config: dict, seed: int) -> Union:
    db = generate(config["sf"], seed=seed)
    cust, _ = renamed(db, "customer", CUSTOMER)
    ords, _ = renamed(db, "orders", ORDERS)
    rels = {
        "customer": cust, "orders": ords,
        "cust_a": _project(cust, ["ck", "nk", "c_name", "c_address"]),
        "cust_b": _project(cust, ["ck", "c_phone", "c_acctbal",
                                  "c_mktsegment", "c_comment"]),
        "ord_a": _project(ords, ["ok", "ck", "o_orderstatus", "o_totalprice",
                                 "o_orderdate"]),
        "ord_b": _project(ords, ["ok", "o_orderpriority", "o_clerk",
                                 "o_shippriority", "o_comment"]),
    }
    keys = {r: ("ok",) if r.startswith("ord") else ("ck",) for r in rels}
    shapes = {
        "SPLIT": [Node("cust_a", ()), Node("cust_b", ("ck",), "cust_a"),
                  Node("ord_a", ("ck",), "cust_a"),
                  Node("ord_b", ("ok",), "ord_a")],
        "ORDERS_SPLIT": [Node("customer", ()), Node("ord_a", ("ck",)),
                         Node("ord_b", ("ok",))],
        "WHOLE": [Node("customer", ()), Node("orders", ("ck",))],
    }
    c = variant_masks(cust["ck"].size, 3, config["overlap"], seed=seed + 1)
    o = variant_masks(ords["ok"].size, 3, config["overlap"], seed=seed + 2)
    joins = [Join(name, {r: (o if r.startswith("ord") else c)[v]
                         for r in rels}, [], nodes)
             for v, (name, nodes) in enumerate(shapes.items())]
    return Union(rels, keys, [], joins)


def _cyclic(config: dict, seed: int) -> Union:
    db = generate(config["sf"], seed=seed)
    rels = {
        "nation": renamed(db, "nation", {"n_nationkey": "nk"})[0],
        "customer": renamed(db, "customer", CUSTOMER)[0],
        "orders": renamed(db, "orders", ORDERS)[0],
        "lineitem": renamed(db, "lineitem", {"l_orderkey": "ok",
                                             "l_suppkey": "sk"})[0],
        "supplier": renamed(db, "supplier", {"s_suppkey": "sk"})[0],
    }
    s = rels["supplier"]
    rels["supp_nation"] = {"sk": s["sk"], "nk": s["s_nationkey"]}
    keys = {"nation": ("nk",), "customer": ("ck",), "orders": ("ok",),
            "lineitem": ("ok", "l_linenumber"), "supplier": ("sk",),
            "supp_nation": ("sk",)}
    nodes = [Node("nation", ()), Node("customer", ("nk",)),
             Node("orders", ("ck",)), Node("lineitem", ("ok",)),
             Node("supplier", ("sk",)),
             Node("supp_nation", ("sk", "nk"), kind="residual")]
    n = len(config["joins"])
    masks = {r: variant_masks(rels[r][keys[r][0]].size, n, config["overlap"],
                              seed=seed + 17 + i)
             for i, r in enumerate(list(rels)[:5])}
    joins = [Join(spec["name"], {r: m[v] for r, m in masks.items()}, [], nodes)
             for v, spec in enumerate(config["joins"])]
    return Union(rels, keys, [], joins)


# ---------------------------------------------------------------- reference
def reference(union: Union, precision: str = "f64") -> "BruteUnion":
    if precision != "f64":
        raise ValueError(f"the brute-force reference is exact; {precision!r}")
    return BruteUnion(union)


def _bytes(mat: np.ndarray) -> List[bytes]:
    mat = np.ascontiguousarray(mat, dtype=np.int64)
    return [row.tobytes() for row in mat]


class BruteUnion:
    """Every join materialised as base row ids per node, its tuples as
    values over the shared output schema, and the cover's pieces by set
    difference."""

    def __init__(self, union: Union):
        if any(j.preds for j in union.joins):
            raise ValueError("the brute-force reference takes no predicates")
        self.union = union
        self.attrs = union.output_attrs()
        self.ids: List[np.ndarray] = []
        self.tuples: List[set] = []
        values: List[List[bytes]] = []
        for k in range(len(union.joins)):
            ids, vals = self._materialise(k)
            self.ids.append(ids)
            values.append(_bytes(np.stack([vals[a] for a in self.attrs], axis=1)))
            self.tuples.append(set(values[-1]))
        self.sizes = np.zeros(len(union.joins))
        self.marg: List[List[np.ndarray]] = []
        for k, ids in enumerate(self.ids):
            fresh = np.asarray([not any(t in self.tuples[q] for q in range(k))
                                for t in values[k]], bool)
            self.sizes[k] = fresh.sum()
            self.marg.append([np.bincount(ids[fresh, p], minlength=n)
                              .astype(np.float64)
                              for p, n in enumerate(self.node_rows(k))])
        self._rows: Dict[str, Dict[bytes, int]] = {}

    def _materialise(self, k: int) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """(tuples, nodes) base row ids of join ``k``, and its tuples'
        values per attribute."""
        u, j = self.union, self.union.joins[k]
        root, *rest = u.nodes(k)
        ids, vals = self._kept(j, root.relation)
        ids = ids[:, None]
        vals = {a: c[ids[:, 0]] for a, c in vals.items()}
        for node in rest:
            rows, cols = self._kept(j, node.relation)
            index: Dict[bytes, List[int]] = {}
            for r, key in zip(rows, _bytes(np.stack(
                    [cols[a][rows] for a in node.edge], axis=1))):
                index.setdefault(key, []).append(r)
            pairs = [(t, r) for t, key in enumerate(_bytes(np.stack(
                [vals[a] for a in node.edge], axis=1)))
                for r in index.get(key, ())]
            t = np.asarray([a for a, _ in pairs], np.int64)
            r = np.asarray([b for _, b in pairs], np.int64)
            ids = np.concatenate([ids[t], r[:, None]], axis=1)
            vals = {a: c[t] for a, c in vals.items()}
            for a, c in cols.items():
                vals.setdefault(a, c[r])
        return ids, vals

    def _kept(self, join, rel):
        """The rows of ``rel`` that ``join`` keeps, and its columns."""
        cols = self.union.relations[rel]
        n = len(next(iter(cols.values())))
        return np.flatnonzero(join.masks.get(rel, np.ones(n, bool))), cols

    # ------------------------------------------------- the judge's interface
    def nodes(self, k: int) -> List[str]:
        return [n.relation for n in self.union.nodes(k)]

    def node_rows(self, k: int) -> List[int]:
        return [len(next(iter(self.union.relations[r].values())))
                for r in self.nodes(k)]

    def pieces(self):
        return self.sizes, self.marg

    def locate(self, rows: Dict[str, np.ndarray], k: int) -> np.ndarray:
        n = len(next(iter(rows.values())))
        out = np.full((n, len(self.nodes(k))), -1, np.int64)
        for p, rel in enumerate(self.nodes(k)):
            cols = self.union.relations[rel]
            if rel not in self._rows:
                self._rows[rel] = {b: i for i, b in enumerate(_bytes(
                    np.stack(list(cols.values()), axis=1)))}
            asked = _bytes(np.stack([rows[a] for a in cols], axis=1))
            out[:, p] = [self._rows[rel].get(b, -1) for b in asked]
        return out

    def member(self, rows: Dict[str, np.ndarray], q: int) -> np.ndarray:
        asked = _bytes(np.stack([rows[a] for a in self.attrs], axis=1))
        return np.asarray([b in self.tuples[q] for b in asked], bool)
