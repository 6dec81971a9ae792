"""The evaluation workloads of this slice: UQ1 (§9) and the cyclic UQ4.

Port copy of ``repro.data.workloads`` (same seeds, same arrays):

* **UQ1** — five chain joins, five relations each
  (nation ⋈ supplier ⋈ customer ⋈ orders ⋈ lineitem), one variant database
  per join sharing ``overlap`` of the base rows.
* **UQ4** — union of a cyclic join (supplier ⋈ partsupp ⋈ part + a
  cycle-closing preferred-supplier relation as the §8.2 residual) with an
  equivalent denormalised chain.

UQ2 (§8.3 predicates) and UQ3 (vertical/horizontal splits) wait for later
slices.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..core.index import Catalog
from ..core.joins import JoinNode, JoinSpec, chain_join, full_join
from ..core.relation import Relation
from .tpch import TpchLite, generate, make_variants


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


WORKLOADS = {"UQ1": uq1, "UQ4": uq4}
