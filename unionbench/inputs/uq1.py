"""UQ1 (the paper's §9): chains nation ⋈ supplier ⋈ customer ⋈ orders ⋈
lineitem over TPC-H data, one variant database per join that shares
``overlap`` of the base rows (each join keeps the first ``overlap`` of
every relation's rows and an independent half of the rest)."""

from __future__ import annotations

from . import Join, Node, Union, config_preds
from .tpch import generate, renamed, variant_masks

# (relation, join attributes renamed to the names the chain shares, edge)
CHAIN = (("nation", {"n_nationkey": "nk"}, ()),
         ("supplier", {"s_nationkey": "nk"}, ("nk",)),
         ("customer", {"c_nationkey": "nk", "c_custkey": "ck"}, ("nk",)),
         ("orders", {"o_custkey": "ck", "o_orderkey": "ok"}, ("ck",)),
         ("lineitem", {"l_orderkey": "ok"}, ("ok",)))


def build(config: dict, seed: int) -> Union:
    db = generate(config["sf"], seed=seed)
    base, keys = {}, {}
    for rel, names, _ in CHAIN:
        base[rel], keys[rel] = renamed(db, rel, names)
    names = [j["name"] for j in config["joins"]]
    masks = {rel: variant_masks(len(next(iter(cols.values()))), len(names),
                                config["overlap"], seed=seed + 17 + i)
             for i, (rel, cols) in enumerate(base.items())}
    joins = [Join(name, {rel: masks[rel][v] for rel in base},
                  config_preds(spec.get("preds", ())))
             for v, (name, spec) in enumerate(zip(names, config["joins"]))]
    return Union(base, keys, [Node(r, e) for r, _, e in CHAIN], joins)
