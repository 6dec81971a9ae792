"""TPC-H-lite generator (DBGen analogue) with scale / skew / overlap knobs.

Port copy of ``repro.data.tpch`` (numpy only; the same seed gives the same
arrays as the reference).

Produces dict-encoded integer relations mirroring the TPC-H schema subset the
paper's workloads touch (§9): region, nation, supplier, customer, orders,
lineitem, partsupp, part.  Two generator features reproduce the paper's
experimental axes:

* ``scale``          — row counts scale linearly (TPC-H-proportioned bases).
* ``overlap``        — :func:`make_variants` derives per-join variant copies
  of a relation that share exactly the first ``overlap`` fraction of rows (the
  "overlap scale P%" of §9) plus independent 50% subsets of the remainder
  (whose higher-order coincidental overlap is negligible).
* ``skew``           — optional Zipf exponent on FK assignments (orders per
  customer, lineitems per order), exercising the bias the paper notes for
  Theorem 4 under skew.

Every relation includes its primary key, so rows — and therefore join output
tuples — are duplicate-free (the paper's §3 no-duplicates assumption).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..core.relation import Relation

BASES = dict(region=5, nation=25, supplier=100, part=2000, partsupp=8000,
             customer=1500, orders=15_000, lineitem=60_000)


def _zipf_choice(rng: np.random.Generator, n_values: int, size: int,
                 skew: float) -> np.ndarray:
    if skew <= 0:
        return rng.integers(0, n_values, size=size)
    w = 1.0 / np.power(np.arange(1, n_values + 1, dtype=np.float64), skew)
    w /= w.sum()
    return rng.choice(n_values, size=size, p=w)


@dataclasses.dataclass
class TpchLite:
    relations: Dict[str, Relation]
    scale: float
    skew: float

    def __getitem__(self, name: str) -> Relation:
        return self.relations[name]


def generate(scale: float = 0.02, seed: int = 0, skew: float = 0.0) -> TpchLite:
    rng = np.random.default_rng(seed)
    n = {k: max(int(v * scale), 3) for k, v in BASES.items()}
    n["region"], n["nation"] = 5, 25

    region = Relation("region", {"rk": np.arange(n["region"])})
    nation = Relation("nation", {
        "nk": np.arange(n["nation"]),
        "rk": rng.integers(0, n["region"], n["nation"]),
    })
    supplier = Relation("supplier", {
        "sk": np.arange(n["supplier"]),
        "s_nk": rng.integers(0, n["nation"], n["supplier"]),
        "sbal": rng.integers(0, 1000, n["supplier"]),
    })
    part = Relation("part", {
        "pk": np.arange(n["part"]),
        "psize": rng.integers(1, 51, n["part"]),
        "ptype": rng.integers(0, 150, n["part"]),
    })
    ps_pairs = rng.choice(n["part"] * n["supplier"],
                          size=min(n["partsupp"], n["part"] * n["supplier"]),
                          replace=False)
    partsupp = Relation("partsupp", {
        "pk": ps_pairs // n["supplier"],
        "sk": ps_pairs % n["supplier"],
        "ps_cost": rng.integers(0, 1000, ps_pairs.shape[0]),
    })
    customer = Relation("customer", {
        "ck": np.arange(n["customer"]),
        "nk": rng.integers(0, n["nation"], n["customer"]),
        "cbal": rng.integers(0, 1000, n["customer"]),
        "mkt": rng.integers(0, 5, n["customer"]),
    })
    orders = Relation("orders", {
        "ok": np.arange(n["orders"]),
        "ck": _zipf_choice(rng, n["customer"], n["orders"], skew),
        "odate": rng.integers(0, 2556, n["orders"]),
        "oprio": rng.integers(0, 5, n["orders"]),
    })
    lineitem = Relation("lineitem", {
        "ok": _zipf_choice(rng, n["orders"], n["lineitem"], skew),
        "ln": np.zeros(n["lineitem"], dtype=np.int64),  # fixed below (unique per ok)
        "pk": rng.integers(0, n["part"], n["lineitem"]),
        "l_sk": rng.integers(0, n["supplier"], n["lineitem"]),
        "qty": rng.integers(1, 51, n["lineitem"]),
    })
    # line numbers unique within an order (=> duplicate-free rows)
    ok_col = lineitem.columns["ok"]
    order_sort = np.argsort(ok_col, kind="stable")
    ln = np.zeros_like(ok_col)
    sorted_ok = ok_col[order_sort]
    new_run = np.concatenate([[True], sorted_ok[1:] != sorted_ok[:-1]])
    run_ids = np.cumsum(new_run) - 1
    run_starts = np.nonzero(new_run)[0]
    ln[order_sort] = np.arange(sorted_ok.shape[0]) - run_starts[run_ids]
    lineitem = lineitem.with_column("ln", ln)

    return TpchLite({r.name: r for r in
                     (region, nation, supplier, part, partsupp, customer,
                      orders, lineitem)}, scale, skew)


def make_variants(rel: Relation, n_variants: int, overlap: float,
                  seed: int = 0, keep_rest: float = 0.5) -> List[Relation]:
    """Variant copies sharing exactly the first ``overlap`` fraction of rows."""
    rng = np.random.default_rng(seed)
    n = rel.nrows
    core = int(round(n * overlap))
    out = []
    for v in range(n_variants):
        keep = np.zeros(n, dtype=bool)
        keep[:core] = True
        keep[core:] = rng.random(n - core) < keep_rest
        out.append(rel.filter(keep, name=f"{rel.name}@v{v}"))
    return out


def vertical_split(rel: Relation, groups: List[List[str]],
                   key_attrs: List[str]) -> List[Relation]:
    """Lossless vertical split: every part keeps the key attributes."""
    return [rel.project(list(dict.fromkeys(key_attrs + g)),
                        name=f"{rel.name}|{'_'.join(g) or i}")
            for i, g in enumerate(groups)]


def horizontal_split(rel: Relation, fraction: float, seed: int = 0,
                     name: Optional[str] = None) -> Relation:
    """The rows a seeded coin keeps with probability ``fraction``."""
    rng = np.random.default_rng(seed)
    keep = rng.random(rel.nrows) < fraction
    return rel.filter(keep, name=name or f"{rel.name}~h")
