"""The benchmark's inputs and its plain reference: the TPC-H rules of the
generator, catching a row planted in an earlier piece, and the bfloat16
control failing where the exact reference passes."""

import json

import numpy as np
import pytest

from unionbench import inputs
from unionbench.inputs import tpch
from unionbench.reference.chain_union import ChainUnion, bf16
from unionbench.reference.judge import judge, passes
from unionbench.tests import support

NAMES = ["request_size_errors", "rows_not_in_home", "rows_in_earlier_piece",
         "law_z", "union_law_z", "dup_z"]


def _config(name, **kw):
    cfg = json.loads((support.PKG / "configs" / f"{name}.json").read_text())
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("seed", [0, support.SEED])
def test_generator_follows_the_tpch_rules(seed):
    """Every TPC-H column, the specification's row counts and key laws."""
    sf = 0.01
    db = tpch.generate(sf, seed=seed)
    width = dict(region=3, nation=4, supplier=7, customer=8, part=9,
                 partsupp=5, orders=9, lineitem=16)
    assert {k: len(v) for k, v in db.items()} == width
    n = tpch.counts(sf)
    for rel, cols in db.items():
        rows = {c.size for c in cols.values()}
        assert len(rows) == 1
        key = np.stack([cols[a] for a in tpch.PRIMARY_KEYS[rel]], axis=1)
        assert np.unique(key, axis=0).shape[0] == key.shape[0], rel
        assert all(c.min() >= 0 and c.max() < 2 ** 31 for c in cols.values())
        if rel != "lineitem":
            assert rows == {n[rel]}, rel
    ps, li, o = db["partsupp"], db["lineitem"], db["orders"]
    assert (np.bincount(ps["ps_partkey"])[1:] == 4).all()
    pairs = ps["ps_partkey"] * 10 ** 6 + ps["ps_suppkey"]
    assert np.isin(li["l_partkey"] * 10 ** 6 + li["l_suppkey"], pairs).all()
    assert ((o["o_orderkey"] - 1) % 32 < 8).all()
    assert (o["o_custkey"] % 3 != 0).all()
    lines = np.bincount(np.searchsorted(o["o_orderkey"], li["l_orderkey"]),
                        minlength=o["o_orderkey"].size)
    assert lines.min() == 1 and lines.max() == 7
    assert (li["l_linenumber"] <= lines[np.searchsorted(
        o["o_orderkey"], li["l_orderkey"])]).all()
    np.testing.assert_array_equal(
        li["l_extendedprice"],
        li["l_quantity"] * tpch.retail_cents(li["l_partkey"]))
    assert (li["l_receiptdate"] > li["l_shipdate"]).all()
    np.testing.assert_array_equal(db["nation"]["n_regionkey"],
                                  tpch.NATION_REGION)


@pytest.mark.parametrize("name,builder", [("uq1-sf1", "uq1"),
                                          ("uq2-sf1", "uq2")])
def test_builders_keep_every_column_and_share_join_names(name, builder):
    """Each chain holds every TPC-H column of its relations, its joins
    share the renamed key attributes, and every join has tuples."""
    union = inputs.build(_config(name, **support.SCALES[builder]), 7)
    db = tpch.generate(support.SCALES[builder]["sf"], seed=7)
    for p, node in enumerate(union.chain):
        cols = union.relations[node.relation]
        assert len(cols) == len(db[node.relation])
        assert set(union.keys[node.relation]) <= set(cols)
        if p:
            parent = union.relations[union.chain[p - 1].relation]
            assert node.edge and set(node.edge) <= set(cols) & set(parent)
    ref = ChainUnion(union)
    assert all(ref.size((j,)) > 0 for j in range(len(union.joins)))


def test_planted_rows_are_caught():
    union = inputs.build(_config("uq1-sf1", **support.SCALES["uq1"]), 11)
    ref = ChainUnion(union)
    ids, home = ref.sample(20_000, np.random.default_rng(1))
    rows = ref.rows_of(ids)
    clean, _ = judge(ref, [len(home)], [len(home)], rows, home, NAMES)
    assert passes(clean, dict.fromkeys(NAMES, 10.0) | {
        "request_size_errors": 0, "rows_not_in_home": 0,
        "rows_in_earlier_piece": 0})
    # rows of piece 0 that J1 holds too, credited to piece 1
    both = np.flatnonzero((home == 0) & ref.member(rows, 1))[:5]
    assert both.size == 5
    planted = home.copy()
    planted[both] = 1
    got, _ = judge(ref, [1], [1], rows, planted, NAMES)
    assert got["rows_in_earlier_piece"] == 5 and got["rows_not_in_home"] == 0
    altered = {a: c.copy() for a, c in rows.items()}
    altered["l_quantity"][:3] += 100
    got, _ = judge(ref, [1], [1], altered, home, NAMES)
    assert got["rows_not_in_home"] == 3


def test_bf16_rounds_to_nearest_even():
    x = np.asarray([1.0, 1 + 2 ** -8, 1 + 3 * 2 ** -8, 257.0, 6_000_000.0])
    np.testing.assert_array_equal(
        bf16(x), [1.0, 1.0, 1 + 2 ** -6, 256.0, 183 * 2.0 ** 15])


@pytest.mark.parametrize("precision,fails", [("f64", False), ("bf16", True)])
def test_control_fails_where_the_reference_passes(precision, fails):
    """The reference in the program's place, at a size a test holds (UQ2 at
    SF 0.4), judged against the cell's own limits."""
    limits = json.loads((support.PKG / "checks" / "uq2-sf1.stream.json")
                        .read_text())
    union = inputs.build(_config("uq2-sf1", sf=0.4), support.SEED)
    exact = ChainUnion(union)
    place = exact if precision == "f64" else ChainUnion(union, precision)
    ids, home = place.sample(200_000, np.random.default_rng(3))
    got, _ = judge(exact, [len(home)], [200_000], exact.rows_of(ids), home,
                   list(limits))
    assert passes(got, limits) != fails, got
