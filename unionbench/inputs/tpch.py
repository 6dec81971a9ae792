"""TPC-H data by the specification's rules: the benchmark's own generator,
numpy only, from a seed.

Every relation has all of its columns (region 3, nation 4, supplier 7,
customer 8, part 9, partsupp 5, orders 9, lineitem 16), under their TPC-H
names, and the key laws of TPC-H v3 §4.2.3:

* row counts are SF × 10,000 suppliers, 150,000 customers, 200,000 parts,
  800,000 partsupp rows and 1,500,000 orders; 25 nations, 5 regions;
* every part has four suppliers, ``ps_suppkey = (ps_partkey + i × (S/4 +
  (ps_partkey - 1)/S)) mod S + 1`` for ``i`` in 0..3;
* order keys are sparse (the first 8 of every 32), ``o_custkey`` is a
  customer key not divisible by 3 (a third of the customers place no
  order), and every order has 1 to 7 lines, uniformly;
* ``l_suppkey`` is one of the four suppliers of ``l_partkey``;
  ``l_extendedprice``, ship, commit and receipt dates, return flag and
  line status, ``o_orderstatus`` and ``o_totalprice`` follow the
  specification's formulas.

Values are held as the program holds them (non-negative dictionary codes
in the int32 domain, as its relations are dict-encoded int64 columns):
text columns (names, addresses, phones, comments, flags, modes) as codes,
decimals in cents (account balances offset by 999.99 to stay
non-negative), dates as days since 1992-01-01.  Every relation holds its
primary key, so rows, and therefore join output tuples, are
duplicate-free.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

Columns = Dict[str, np.ndarray]

# TPC-H's nation table: n_regionkey of nations 0..24
NATION_REGION = (0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2, 3,
                 4, 2, 3, 3, 1)
END_ORDER_DAY = 2405            # 1998-12-31 less 151 days, from 1992-01-01
CURRENT_DAY = 1263              # 1995-06-17
ACCTBAL_OFFSET = 99_999         # -999.99 .. 9,999.99 in cents, shifted

PRIMARY_KEYS = dict(region=("r_regionkey",), nation=("n_nationkey",),
                    supplier=("s_suppkey",), customer=("c_custkey",),
                    part=("p_partkey",), partsupp=("ps_partkey", "ps_suppkey"),
                    orders=("o_orderkey",),
                    lineitem=("l_orderkey", "l_linenumber"))


def counts(sf: float) -> Dict[str, int]:
    """Row counts at scale factor ``sf`` (lineitem's is drawn)."""
    n = dict(supplier=10_000, customer=150_000, part=200_000,
             orders=1_500_000)
    out = {k: max(int(round(v * sf)), 4) for k, v in n.items()}
    out.update(region=5, nation=25, partsupp=4 * out["part"])
    return out


def _codes(rng: np.random.Generator, n: int) -> np.ndarray:
    """Dictionary codes of ``n`` distinct random texts (comments, names of
    random words, addresses): a permutation of ``0..n-1``."""
    return rng.permutation(n)


def _phones(rng: np.random.Generator, nk: np.ndarray) -> np.ndarray:
    """Dictionary codes of ``CC-LLL-LLL-LLLL`` phones, country code
    ``nationkey + 10``."""
    local = (rng.integers(100, 1000, nk.size) * 10 ** 7
             + rng.integers(100, 1000, nk.size) * 10 ** 4
             + rng.integers(1000, 10_000, nk.size))
    return np.unique((nk + 10) * 10 ** 10 + local, return_inverse=True)[1]


def _supplier_of(partkey: np.ndarray, i: np.ndarray, s: int) -> np.ndarray:
    return (partkey + i * (s // 4 + (partkey - 1) // s)) % s + 1


def retail_cents(partkey: np.ndarray) -> np.ndarray:
    return 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1000)


def generate(sf: float, seed: int) -> Dict[str, Columns]:
    """The eight relations at scale factor ``sf``, from ``seed``."""
    rng = np.random.default_rng(seed)
    n = counts(sf)
    S, C, P, O = n["supplier"], n["customer"], n["part"], n["orders"]
    out: Dict[str, Columns] = {}
    out["region"] = dict(r_regionkey=np.arange(5), r_name=np.arange(5),
                         r_comment=_codes(rng, 5))
    out["nation"] = dict(n_nationkey=np.arange(25), n_name=np.arange(25),
                         n_regionkey=np.asarray(NATION_REGION),
                         n_comment=_codes(rng, 25))
    s_nk = rng.integers(0, 25, S)
    out["supplier"] = dict(
        s_suppkey=np.arange(1, S + 1), s_name=np.arange(S),
        s_address=_codes(rng, S), s_nationkey=s_nk, s_phone=_phones(rng, s_nk),
        s_acctbal=rng.integers(-99_999, 1_000_000, S) + ACCTBAL_OFFSET,
        s_comment=_codes(rng, S))
    c_nk = rng.integers(0, 25, C)
    out["customer"] = dict(
        c_custkey=np.arange(1, C + 1), c_name=np.arange(C),
        c_address=_codes(rng, C), c_nationkey=c_nk, c_phone=_phones(rng, c_nk),
        c_acctbal=rng.integers(-99_999, 1_000_000, C) + ACCTBAL_OFFSET,
        c_mktsegment=rng.integers(0, 5, C), c_comment=_codes(rng, C))
    pk = np.arange(1, P + 1)
    mfgr = rng.integers(1, 6, P)
    out["part"] = dict(
        p_partkey=pk, p_name=_codes(rng, P), p_mfgr=mfgr,
        p_brand=mfgr * 10 + rng.integers(1, 6, P),
        p_type=rng.integers(0, 150, P), p_size=rng.integers(1, 51, P),
        p_container=rng.integers(0, 40, P), p_retailprice=retail_cents(pk),
        p_comment=_codes(rng, P))
    ps_pk = np.repeat(pk, 4)
    ps_sk = _supplier_of(ps_pk, np.tile(np.arange(4), P), S)
    # at tiny scale factors two of a part's four suppliers can coincide:
    # keep one
    _, first = np.unique(ps_pk * (S + 1) + ps_sk, return_index=True)
    keep = np.sort(first)
    ps_pk, ps_sk = ps_pk[keep], ps_sk[keep]
    out["partsupp"] = dict(
        ps_partkey=ps_pk, ps_suppkey=ps_sk,
        ps_availqty=rng.integers(1, 10_000, ps_pk.size),
        ps_supplycost=rng.integers(100, 100_001, ps_pk.size),
        ps_comment=_codes(rng, ps_pk.size))

    j = np.arange(O)
    okey = (j // 8) * 32 + j % 8 + 1
    ordering = np.arange(1, C + 1)
    ordering = ordering[ordering % 3 != 0]
    odate = rng.integers(0, END_ORDER_DAY + 1, O)
    lines = rng.integers(1, 8, O)
    L = int(lines.sum())
    start = np.concatenate([[0], np.cumsum(lines)[:-1]])
    l_ok = np.repeat(okey, lines)
    l_ln = np.arange(L) - np.repeat(start, lines) + 1
    l_pk = rng.integers(1, P + 1, L)
    l_sk = _supplier_of(l_pk, rng.integers(0, 4, L), S)
    qty = rng.integers(1, 51, L)
    price = qty * retail_cents(l_pk)
    disc = rng.integers(0, 11, L)
    tax = rng.integers(0, 9, L)
    l_odate = np.repeat(odate, lines)
    ship = l_odate + rng.integers(1, 122, L)
    commit = l_odate + rng.integers(30, 91, L)
    receipt = ship + rng.integers(1, 31, L)
    # return flag: R (0) or A (1) once received, else N (2)
    flag = np.where(receipt <= CURRENT_DAY, rng.integers(0, 2, L), 2)
    status = (ship > CURRENT_DAY).astype(np.int64)      # O (1) or F (0)
    out["lineitem"] = dict(
        l_orderkey=l_ok, l_partkey=l_pk, l_suppkey=l_sk, l_linenumber=l_ln,
        l_quantity=qty, l_extendedprice=price, l_discount=disc, l_tax=tax,
        l_returnflag=flag, l_linestatus=status, l_shipdate=ship,
        l_commitdate=commit, l_receiptdate=receipt,
        l_shipinstruct=rng.integers(0, 4, L), l_shipmode=rng.integers(0, 7, L),
        l_comment=_codes(rng, L))
    open_lines = np.add.reduceat(status, start)
    charge = price * (100 + tax) * (100 - disc) // 10_000
    out["orders"] = dict(
        o_orderkey=okey, o_custkey=ordering[rng.integers(0, ordering.size, O)],
        # F (0) all lines shipped, O (1) none, P (2) some
        o_orderstatus=np.where(open_lines == 0, 0,
                               np.where(open_lines == lines, 1, 2)),
        o_totalprice=np.add.reduceat(charge, start), o_orderdate=odate,
        o_orderpriority=rng.integers(0, 5, O),
        o_clerk=rng.integers(1, max(int(round(1000 * sf)), 1) + 1, O),
        o_shippriority=np.zeros(O, np.int64), o_comment=_codes(rng, O))
    return {name: {a: np.asarray(c, dtype=np.int64) for a, c in cols.items()}
            for name, cols in out.items()}


def renamed(db: Dict[str, Columns], rel: str, names: Dict[str, str]):
    """(columns, primary key) of ``rel`` with the join attributes renamed
    to the names the chain shares."""
    cols = {names.get(a, a): c for a, c in db[rel].items()}
    return cols, tuple(names.get(a, a) for a in PRIMARY_KEYS[rel])


def variant_masks(nrows: int, n_variants: int, overlap: float, seed: int,
                  keep_rest: float = 0.5) -> List[np.ndarray]:
    """Row masks of ``n_variants`` variant copies that share exactly the
    first ``overlap`` fraction of rows and keep each later row with
    probability ``keep_rest``."""
    rng = np.random.default_rng(seed)
    core = int(round(nrows * overlap))
    out = []
    for _ in range(n_variants):
        keep = np.zeros(nrows, dtype=bool)
        keep[:core] = True
        keep[core:] = rng.random(nrows - core) < keep_rest
        out.append(keep)
    return out
