"""TPC-H Q5's join graph (the §8.2 cyclic join): the skeleton nation ⋈
customer ⋈ orders ⋈ lineitem ⋈ supplier (on ``l_suppkey``) and a residual
(suppkey, nationkey) relation that closes the cycle ``c_nationkey =
s_nationkey``.  One variant database per join, as UQ1's: every skeleton
relation keeps the first ``overlap`` of its rows and an independent half of
the rest; the residual is kept whole."""

from __future__ import annotations

from . import Join, Node, Union, config_preds
from .tpch import generate, renamed, variant_masks

# (relation, join attributes renamed to the names the join shares, edge)
SKELETON = (("nation", {"n_nationkey": "nk"}, ()),
            ("customer", {"c_nationkey": "nk", "c_custkey": "ck"}, ("nk",)),
            ("orders", {"o_custkey": "ck", "o_orderkey": "ok"}, ("ck",)),
            ("lineitem", {"l_orderkey": "ok", "l_suppkey": "sk"}, ("ok",)),
            ("supplier", {"s_suppkey": "sk"}, ("sk",)))
RESIDUAL = "supp_nation"        # supplier's (suppkey, nationkey), keyed by sk


def build(config: dict, seed: int) -> Union:
    db = generate(config["sf"], seed=seed)
    base, keys = {}, {}
    for rel, names, _ in SKELETON:
        base[rel], keys[rel] = renamed(db, rel, names)
    base[RESIDUAL] = {"sk": base["supplier"]["sk"],
                      "nk": base["supplier"]["s_nationkey"]}
    keys[RESIDUAL] = ("sk",)
    names = [j["name"] for j in config["joins"]]
    masks = {rel: variant_masks(len(base[rel][keys[rel][0]]), len(names),
                                config["overlap"], seed=seed + 17 + i)
             for i, (rel, _, _) in enumerate(SKELETON)}
    nodes = [Node(rel, edge) for rel, _, edge in SKELETON]
    nodes.append(Node(RESIDUAL, ("sk", "nk"), kind="residual"))
    joins = [Join(name, {rel: masks[rel][v] for rel in masks},
                  config_preds(spec.get("preds", ())), list(nodes))
             for v, (name, spec) in enumerate(zip(names, config["joins"]))]
    return Union(base, keys, [], joins)
