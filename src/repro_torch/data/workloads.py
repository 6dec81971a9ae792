"""The evaluation workloads of the port: UQ1, UQ2, UQ3 (§9) and the cyclic UQ4.

Port copy of ``repro.data.workloads`` (same seeds, same arrays):

* **UQ1** — five chain joins, five relations each
  (nation ⋈ supplier ⋈ customer ⋈ orders ⋈ lineitem), one variant database
  per join sharing ``overlap`` of the base rows.
* **UQ2** — three chain joins over the *same* data
  (region ⋈ nation ⋈ supplier ⋈ partsupp ⋈ part) distinguished only by
  overlapping selection predicates on ``psize`` (the high-overlap workload,
  the paper's Q2 flavours), in either §8.3 predicate mode.
* **UQ3** — one acyclic (branching-tree) join + two chain joins derived
  from customer/orders via vertical splits — different relation schemas,
  same output schema: exercises the §5.2 splitting method.
* **UQ4** — union of a cyclic join (supplier ⋈ partsupp ⋈ part + a
  cycle-closing preferred-supplier relation as the §8.2 residual) with an
  equivalent denormalised chain.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..core.index import Catalog
from ..core.joins import JoinNode, JoinSpec, chain_join, full_join
from ..core.predicates import Pred, pushdown, rejection
from ..core.relation import Relation
from .tpch import TpchLite, generate, make_variants, vertical_split


@dataclasses.dataclass
class Workload:
    name: str
    joins: List[JoinSpec]
    cat: Catalog
    db: TpchLite


def uq1(scale: float = 0.02, overlap: float = 0.2, seed: int = 0,
        n_joins: int = 5, skew: float = 0.0) -> Workload:
    db = generate(scale, seed=seed, skew=skew)
    cat = Catalog()
    # supplier joins nation and customer on nk: standardise s_nk -> nk
    base = {
        "nation": db["nation"],
        "supplier": db["supplier"].rename({"s_nk": "nk"}),
        "customer": db["customer"].project(["ck", "nk", "cbal"]),
        "orders": db["orders"],
        "lineitem": db["lineitem"],
    }
    variants = {nm: make_variants(rel, n_joins, overlap, seed=seed + 17 + i)
                for i, (nm, rel) in enumerate(base.items())}
    joins = []
    for v in range(n_joins):
        joins.append(chain_join(
            f"UQ1_J{v}",
            [variants["nation"][v], variants["supplier"][v],
             variants["customer"][v], variants["orders"][v],
             variants["lineitem"][v]],
            [("nk",), ("nk",), ("ck",), ("ok",)],
        ))
    return Workload("UQ1", joins, cat, db)


def uq2(scale: float = 0.02, seed: int = 0, skew: float = 0.0,
        pred_mode: str = "pushdown") -> Workload:
    """UQ2 in either §8.3 predicate mode.

    * ``pred_mode="pushdown"`` — base relations filtered at build time; the
      specs carry pushdown provenance so the device engine rebuilds them as
      validity masks over the shared base relations.
    * ``pred_mode="rejection"`` — the three flavours share the *same*
      unfiltered nodes and differ only in per-join ``reject_preds``;
      candidates failing them are rejected during sampling.
    """
    if pred_mode not in ("pushdown", "rejection"):
        raise ValueError("pred_mode must be 'pushdown' or 'rejection'")
    db = generate(scale, seed=seed, skew=skew)
    cat = Catalog()
    supplier = db["supplier"].rename({"s_nk": "nk"})
    base = chain_join(
        "UQ2_BASE",
        [db["region"], db["nation"], supplier, db["partsupp"], db["part"]],
        [("rk",), ("nk",), ("sk",), ("pk",)],
    )
    # overlapping selection predicates (the paper's Q2^N / Q2^P / Q2^S flavour)
    mk = pushdown if pred_mode == "pushdown" else rejection
    j_n = mk(base, [Pred("psize", "<=", 40)], name="UQ2_JN")
    j_p = mk(base, [Pred("psize", ">=", 10)], name="UQ2_JP")
    j_s = mk(base, [Pred("psize", "in", set(range(5, 46)))], name="UQ2_JS")
    return Workload("UQ2", [j_n, j_p, j_s], cat, db)


def uq3(scale: float = 0.02, overlap: float = 0.2, seed: int = 0) -> Workload:
    db = generate(scale, seed=seed)
    cat = Catalog()
    rng_seed = seed + 101
    # output schema: (ck, nk, cbal, ok, odate)
    cust = db["customer"].project(["ck", "nk", "cbal"])
    ords = db["orders"].project(["ok", "ck", "odate"])
    cust_v = make_variants(cust, 3, overlap, seed=rng_seed)
    ords_v = make_variants(ords, 3, overlap, seed=rng_seed + 1)

    # J3a: branching tree over vertical splits of customer + orders
    # (cust_a has two children, cust_b and ord_a)
    cust_a, cust_b = vertical_split(cust_v[0], [["nk"], ["cbal"]], ["ck"])
    ord_a, ord_b = vertical_split(ords_v[0], [[], ["odate"]], ["ok", "ck"])
    ord_a = ord_a.project(["ok", "ck"], name="ord_a0")
    ord_b = ord_b.project(["ok", "odate"], name="ord_b0")
    j3a = JoinSpec("UQ3_JA", [
        JoinNode("cust_a", cust_a, None, ()),
        JoinNode("cust_b", cust_b, "cust_a", ("ck",)),
        JoinNode("ord_a", ord_a, "cust_a", ("ck",)),
        JoinNode("ord_b", ord_b, "ord_a", ("ok",)),
    ])

    # J3b: chain over un-split customer + vertically split orders
    ord_a1 = ords_v[1].project(["ok", "ck"], name="ord_a1")
    ord_b1 = ords_v[1].project(["ok", "odate"], name="ord_b1")
    j3b = chain_join("UQ3_JB", [cust_v[1].rename({}, name="cust1"),
                                ord_a1, ord_b1], [("ck",), ("ok",)])

    # J3c: 2-relation chain over denormalised orders
    j3c = chain_join("UQ3_JC", [cust_v[2].rename({}, name="cust2"),
                                ords_v[2].rename({}, name="ord2")], [("ck",)])
    return Workload("UQ3", [j3a, j3b, j3c], cat, db)


def uq4(scale: float = 0.02, seed: int = 0) -> Workload:
    """Cyclic union workload: skeleton + residual vs denormalised chain."""
    db = generate(scale, seed=seed)
    cat = Catalog()
    rng = np.random.default_rng(seed + 7)
    supplier = db["supplier"].rename({"s_nk": "nk"})
    partsupp, part = db["partsupp"], db["part"]
    # cycle-closing relation: preferred (pk, sk) pairs, a subset of partsupp pairs
    keep = rng.random(partsupp.nrows) < 0.5
    pref = Relation("pref", {
        "pk": partsupp.columns["pk"][keep],
        "sk": partsupp.columns["sk"][keep],
        "pref_lvl": rng.integers(0, 3, int(keep.sum())),
    })
    j_cyc = JoinSpec("UQ4_CYC", [
        JoinNode("supplier", supplier, None, ()),
        JoinNode("partsupp", partsupp, "supplier", ("sk",)),
        JoinNode("part", part, "partsupp", ("pk",)),
        JoinNode("pref", pref, None, ("pk", "sk"), kind="residual"),
    ])
    # denormalised equivalent: one wide relation for (supplier ⋈ partsupp ⋈ pref)
    wide_spec = JoinSpec("UQ4_WIDE_BASE", [
        JoinNode("supplier", supplier, None, ()),
        JoinNode("partsupp", partsupp, "supplier", ("sk",)),
        JoinNode("pref", pref, None, ("pk", "sk"), kind="residual"),
    ])
    wide_cols = full_join(cat, wide_spec)
    # horizontal 70% subset => partial overlap with the cyclic join
    n = next(iter(wide_cols.values())).shape[0]
    hkeep = np.random.default_rng(seed + 9).random(n) < 0.7
    wide = Relation("ps_wide", {a: c[hkeep] for a, c in wide_cols.items()})
    j_chain = chain_join("UQ4_CHAIN", [wide, part], [("pk",)])
    return Workload("UQ4", [j_cyc, j_chain], cat, db)


WORKLOADS = {"UQ1": uq1, "UQ2": uq2, "UQ3": uq3, "UQ4": uq4}
