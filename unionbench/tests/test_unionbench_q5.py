"""TPC-H Q5's cyclic union (``q5-sf1``): its inputs, its reference
``anchored_union`` against the brute-force reference and the chain
reference, the shapes it refuses, planted faults, its bf16 control, a run
of the cell through the harness and its three readers."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from unionbench import harness, inputs
from unionbench.reference import anchored_union, chain_union
from unionbench.reference.judge import judge, passes
from unionbench.tests import shapes, support

NAMES = ["request_size_errors", "rows_not_in_home", "rows_in_earlier_piece",
         "law_z", "union_law_z", "dup_z"]


def _config(**kw):
    cfg = json.loads((support.PKG / "configs" / "q5-sf1.json").read_text())
    cfg.update(support.SCALES["q5"])
    cfg.update(kw)
    return cfg


def _limits():
    return json.loads((support.PKG / "checks" / "q5-sf1.stream.json")
                      .read_text())


def test_inputs_are_the_cyclic_test_shape():
    """``unionbench/inputs/q5.py`` makes, from the same seed, the union
    that the harness's cyclic test shape makes."""
    cfg = _config()
    got = inputs.build(cfg, support.SEED)
    want = shapes.build(dict(cfg, shape="cyclic"), support.SEED)
    assert got.keys == want.keys
    for rel, cols in want.relations.items():
        assert all(np.array_equal(got.relations[rel][a], c)
                   for a, c in cols.items())
    for k, (a, b) in enumerate(zip(got.joins, want.joins)):
        assert a.masks.keys() == b.masks.keys()
        assert all(np.array_equal(a.masks[r], b.masks[r]) for r in a.masks)
        assert got.nodes(k) == want.nodes(k)


def _probe_rows(union, brute):
    """Tuples of every join (from the brute force), then the same tuples
    with the customer's nation moved (the residual edge broken), then with
    a value altered."""
    per_join = []
    for k, ids in enumerate(brute.ids):
        rows = {}
        for p, rel in enumerate(brute.nodes(k)):
            for a, c in union.relations[rel].items():
                rows.setdefault(a, c[ids[:, p]])
        per_join.append(rows)
    rows = {a: np.concatenate([r[a] for r in per_join]) for a in per_join[0]}
    broken = dict(rows, nk=(rows["nk"] + 1) % 25)
    altered = dict(rows, l_quantity=rows["l_quantity"] + 100)
    both = {a: np.concatenate([rows[a], broken[a], altered[a]]) for a in rows}
    return both, rows["ok"].size


def test_anchored_reference_equals_the_brute_force():
    union = shapes.build(dict(_config(), shape="cyclic"), support.SEED)
    brute = shapes.reference(union)
    ref = anchored_union.reference(union)
    sizes, marg = ref.pieces()
    want_sizes, want_marg = brute.pieces()
    np.testing.assert_array_equal(sizes, want_sizes)
    assert sizes.tolist() == [258, 126, 80]
    for got, want in zip(marg, want_marg):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    rows, n = _probe_rows(union, brute)
    for k in range(len(union.joins)):
        np.testing.assert_array_equal(ref.locate(rows, k),
                                      brute.locate(rows, k))
        got = ref.member(rows, k)
        np.testing.assert_array_equal(got, brute.member(rows, k))
    assert got[:n].any() and not got[n:].any()


def test_anchored_reference_equals_the_chain_reference_on_uq2():
    """UQ2's chains have an anchor too (partsupp): both references give
    the same pieces, marginals and numbers."""
    cfg = json.loads((support.PKG / "configs" / "uq2-sf1.json").read_text())
    union = inputs.build(dict(cfg, sf=0.05), support.SEED)
    a, c = anchored_union.reference(union), chain_union.reference(union)
    (sa, ma), (sc, mc) = a.pieces(), c.pieces()
    np.testing.assert_array_equal(sa, sc)
    for x, y in zip(ma, mc):
        for g, w in zip(x, y):
            np.testing.assert_array_equal(g, w)
    ids, home = c.sample(20_000, np.random.default_rng(2))
    rows = c.rows_of(ids)
    assert judge(a, [1], [1], rows, home, NAMES) == \
        judge(c, [1], [1], rows, home, NAMES)


@pytest.mark.parametrize("shape,words", [
    ("branching", "join 'ORDERS_SPLIT' has other nodes than 'SPLIT'"),
    ("uq1", "'supplier' is joined to 'customer' on \\('nk',\\), not on its "
            "key \\('s_suppkey',\\)")])
def test_anchored_reference_names_the_shape_it_refuses(shape, words):
    if shape == "uq1":
        cfg = json.loads((support.PKG / "configs" / "uq1-sf1.json")
                         .read_text())
        union = inputs.build(dict(cfg, **support.SCALES["uq1"]), support.SEED)
    else:
        union = shapes.build({"shape": shape, "sf": 0.002, "overlap": 0.4},
                             support.SEED)
    with pytest.raises(ValueError, match=words):
        anchored_union.reference(union)


def test_planted_faults_are_caught():
    """Rows of the first piece that the second join holds too, credited to
    it; rows whose customer's nation is not the supplier's."""
    union = inputs.build(_config(), support.SEED)
    ref = anchored_union.reference(union)
    ids, home = ref.sample(4000, np.random.default_rng(1))
    rows = ref.rows_of(ids)
    clean, _ = judge(ref, [1], [1], rows, home, NAMES[:3])
    assert clean == dict.fromkeys(NAMES[:3], 0)
    also = np.flatnonzero((home == 0) & ref.member(rows, 1))[:5]
    assert also.size == 5
    planted = home.copy()
    planted[also] = 1
    got, _ = judge(ref, [1], [1], rows, planted, NAMES[:3])
    assert got["rows_in_earlier_piece"] == 5 and got["rows_not_in_home"] == 0
    broken = {a: c.copy() for a, c in rows.items()}
    broken["s_nationkey"][:4] = (broken["nk"][:4] + 1) % 25
    broken["nk"][4:7] = (broken["s_nationkey"][4:7] + 1) % 25
    got, _ = judge(ref, [1], [1], broken, home, NAMES[:3])
    assert got["rows_not_in_home"] == 7


def test_control_fails_where_the_reference_passes():
    """The exact reference and the bf16 control in the program's place at
    SF 0.05 (200,000 rows), judged against the cell's own limits; exact,
    the skeleton walk draws every skeleton tuple alike."""
    union = inputs.build(_config(sf=0.05), support.SEED)
    exact = anchored_union.reference(union)
    walk = exact.walk_probability(1)
    inside = walk[exact.valid[1]]
    np.testing.assert_allclose(inside, inside[0], rtol=1e-12)
    limits = _limits()
    for precision, fails in (("f64", False), ("bf16", True)):
        place = (exact if precision == "f64"
                 else anchored_union.reference(union, precision))
        ids, home = place.sample(200_000, np.random.default_rng(3))
        got, _ = judge(exact, [1], [1], exact.rows_of(ids), home,
                       list(limits))
        assert passes(got, limits) != fails, (precision, got)


def test_the_cell_runs_correct_and_reads_its_layers(tmp_path):
    """The cell at SF 0.005 through the harness, traced: all six numbers
    under their limits, and the three readers of its layers read."""
    pkg = support.tiny_copy(tmp_path)
    res = harness.execute(support.bench(), "q5-sf1.stream", support.SEED, 2.0,
                          True, torch.device("cpu"), pkg=pkg)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(_limits())
    m = res["metrics"]
    assert 85 < m["round.residual_reject_share"]["value"] < 99
    assert m["loop.rounds_per_ksample"]["value"] > 0
    assert m["build.exact_rows_m"]["value"] > 0


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, {root!r}); "
            "import unionbench.reference.anchored_union; "
            "print(sorted({{m.split('.')[0] for m in sys.modules}}))")
    p = subprocess.run([sys.executable, "-c", code.format(
        root=str(support.ROOT))], capture_output=True, text=True, timeout=60)
    loaded = set(json.loads(p.stdout.replace("'", '"')))
    assert not loaded & {"jax", "jaxlib", "repro", "repro_torch", "torch"}
