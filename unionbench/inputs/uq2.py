"""UQ2 (the paper's §9): chains region ⋈ nation ⋈ supplier ⋈ partsupp ⋈
part over TPC-H data, told apart only by overlapping predicates on
``p_size`` that the configuration lists (§8.3 pushdown mode)."""

from __future__ import annotations

from . import Join, Node, Union, config_preds
from .tpch import generate, renamed

# (relation, join attributes renamed to the names the chain shares, edge)
CHAIN = (("region", {"r_regionkey": "rk"}, ()),
         ("nation", {"n_regionkey": "rk", "n_nationkey": "nk"}, ("rk",)),
         ("supplier", {"s_nationkey": "nk", "s_suppkey": "sk"}, ("nk",)),
         ("partsupp", {"ps_suppkey": "sk", "ps_partkey": "pk"}, ("sk",)),
         ("part", {"p_partkey": "pk"}, ("pk",)))


def build(config: dict, seed: int) -> Union:
    db = generate(config["sf"], seed=seed)
    base, keys = {}, {}
    for rel, names, _ in CHAIN:
        base[rel], keys[rel] = renamed(db, rel, names)
    joins = [Join(spec["name"], {}, config_preds(spec["preds"]))
             for spec in config["joins"]]
    return Union(base, keys, [Node(r, e) for r, _, e in CHAIN], joins)
