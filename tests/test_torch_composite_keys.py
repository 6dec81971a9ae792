"""Composite keys on the port's host probes: an index and every query
against it pack with the index's widths, so equal keys meet whatever the
query side's maxima (a query outside the index's domain is a miss).

* ``full_join``, ``join_size``, ``exact_join_size_distinct`` and the host
  ``JoinSampler``'s exact sizes equal brute-force counts on composite tree
  and residual edges whose two sides have different maxima;
* TPC-H Q5's cyclic union at SF 0.005 counts 258 / 213 / 191 tuples, and
  its exact warm-up passes ``union_law_z`` through the benchmark's harness;
* single-attribute indexes, and every index of the benchmark's UQ1 and UQ2
  catalogs, are bit-identical to the reference package's;
* the warm-up's tracing: ``warmup.materialise`` and
  ``repro_warmup_rows_materialised_total``, and nothing with them off;
* the fused engine counts the §8.2 residual's misses (d = 0) on Q5.
"""

import itertools
import json
import sys

import numpy as np
import pytest
import torch

from repro.core.index import build_index as ref_build_index
from repro_torch import obs
from repro_torch.core.index import Catalog, build_index, query_keys
from repro_torch.core.join_sampler import JoinSampler
from repro_torch.core.joins import (ROWS_MATERIALISED, JoinNode, JoinSpec,
                                    full_join, join_size)
from repro_torch.core.overlap import exact_join_size_distinct
from repro_torch.core.relation import Relation, combine_columns
from unionbench import harness, inputs, program
from unionbench.tests import shapes, support


def _brute(spec: JoinSpec) -> int:
    """Tuples of ``spec`` by nested loops over its expansion order."""
    order = spec.expansion_order()
    rows = [dict(zip(order[0].relation.attrs, v))
            for v in zip(*order[0].relation.columns.values())]
    for n in order[1:]:
        rel = n.relation
        child = [dict(zip(rel.attrs, v)) for v in zip(*rel.columns.values())]
        rows = [dict(r, **c) for r in rows for c in child
                if all(r[a] == c[a] for a in n.edge_attrs)]
    return len(rows)


def test_a_residual_whose_index_reaches_further_is_counted():
    """Four rows against a residual index whose nationkeys reach 9: the
    query side (at most 3) packed with its own widths met no key."""
    a = Relation("a", {"sk": np.array([1, 2, 3, 4]),
                       "nk": np.array([0, 1, 2, 3]), "x": np.arange(4)})
    r = Relation("r", {"sk": np.array([1, 2, 3, 4, 5]),
                       "nk": np.array([0, 1, 2, 9, 3])})
    spec = JoinSpec("w", [JoinNode("a", a, None, ()),
                          JoinNode("r", r, None, ("sk", "nk"),
                                   kind="residual")])
    cat = Catalog()
    assert _brute(spec) == 3
    assert full_join(cat, spec)["x"].tolist() == [0, 1, 2]
    assert join_size(cat, spec) == 3
    assert exact_join_size_distinct(cat, spec) == 3


def _composite(seed: int, kind: str) -> JoinSpec:
    """R(a, b, c) ⋈ S(b, c, d) on (b, c), S's domains wider than R's or
    the other way round, as a tree edge or as a residual."""
    rng = np.random.default_rng(seed)
    wide, narrow = (9, 5) if seed % 2 else (5, 9)
    r = Relation("R", {"a": rng.integers(0, 6, 40),
                       "b": rng.integers(0, narrow, 40),
                       "c": rng.integers(0, narrow, 40), "rid": np.arange(40)})
    s = Relation("S", {"b": rng.integers(0, wide, 60),
                       "c": rng.integers(0, wide, 60),
                       "d": rng.integers(0, 4, 60), "sid": np.arange(60)})
    if kind == "tree":
        return JoinSpec("RS", [JoinNode("R", r, None, ()),
                               JoinNode("S", s, "R", ("b", "c"))])
    # a residual S(b, c) closing R ⋈ T on a
    t = Relation("T", {"a": rng.integers(0, 6, 30), "tid": np.arange(30)})
    s = s.project(["b", "c", "sid"], name="S")
    return JoinSpec("RTS", [JoinNode("R", r, None, ()),
                            JoinNode("T", t, "R", ("a",)),
                            JoinNode("S", s, None, ("b", "c"),
                                     kind="residual")])


@pytest.mark.parametrize("seed,kind", list(itertools.product(
    [0, 1, 2, 3], ["tree", "residual"])))
def test_composite_keys_with_different_maxima_count_as_brute_force(seed, kind):
    spec = _composite(seed, kind)
    want = _brute(spec)
    assert want > 0
    cat = Catalog()
    assert next(iter(full_join(cat, spec).values())).shape[0] == want
    assert join_size(cat, spec) == want
    assert exact_join_size_distinct(cat, spec) == want
    if kind == "tree":
        assert JoinSampler(cat, spec).exact_acyclic_size() == want


def _q5(sf=0.005, **kw):
    cfg = {"shape": "cyclic", "sf": sf, "overlap": 0.4,
           "joins": [{"name": "Q5_J0"}, {"name": "Q5_J1"}, {"name": "Q5_J2"}]}
    cfg.update(kw)
    return shapes.build(cfg, support.SEED)


def test_q5_style_union_counts_as_brute_force():
    """The cyclic union at SF 0.005 on which the host's own widths counted
    324 / 213 / 234 tuples."""
    union = _q5()
    cat, joins = program.specs(union)
    want = [len(t) for t in shapes.reference(union).tuples]
    assert want == [258, 213, 191]
    assert [full_join(cat, j)["ok"].shape[0] for j in joins] == want
    assert [join_size(cat, j) for j in joins] == want
    assert [exact_join_size_distinct(cat, j) for j in joins] == want


def test_q5_style_exact_warmup_passes_the_union_law(tmp_path, monkeypatch):
    """The exact warm-up's cover on the cyclic union, served and judged by
    the benchmark's harness against the brute-force reference: the piece
    shares hold (``union_law_z``)."""
    monkeypatch.setitem(sys.modules, "unionbench.inputs.tiny_shapes", shapes)
    monkeypatch.setitem(sys.modules, "unionbench.reference.brute_union",
                        shapes)
    pkg = support.tiny_copy(tmp_path)
    checks = {"request_size_errors": 0, "rows_not_in_home": 0,
              "rows_in_earlier_piece": 0, "law_z": 20.0, "dup_z": 20.0,
              "union_law_z": 20.0}
    cfg = dict(name="tiny-q5", workload="tiny_shapes", reference="brute_union",
               shape="cyclic", sf=0.005, overlap=0.4,
               joins=[{"name": "Q5_J0"}, {"name": "Q5_J1"}, {"name": "Q5_J2"}],
               warmup={"method": "exact"}, plan="adaptive", round_batch=2048,
               fused_rounds="device", service={"batch": 1024, "prefetch": 2})
    (pkg / "configs" / "tiny-q5.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "small.json").write_text(json.dumps(
        {"driver": "stream", "loop": "closed", "clients": 1,
         "sizes": {"law": "fixed", "size": 512, "grid": 1},
         "check_requests": 32, "warm_s": 0.1}))
    (pkg / "checks" / "tiny-q5.small.json").write_text(json.dumps(checks))
    b = support.bench()
    b["workloads"].append({"name": "tiny-q5.small", "config": "tiny-q5",
                           "traffic": "small", "chips": 1, "why": "test"})
    res = harness.execute(b, "tiny-q5.small", support.SEED, 0.5, False,
                          torch.device("cpu"), pkg=pkg)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(checks)


@pytest.mark.parametrize("workload", ["uq1", "uq2"])
def test_benchmark_indexes_are_the_reference_packages(workload):
    """Every index the UQ1 and UQ2 joins probe, and each relation's key
    columns, pack exactly as the reference package (and the port before
    composite queries took the index's widths) packs them."""
    cfg = json.loads((support.PKG / "configs" / f"{workload}-sf1.json")
                     .read_text())
    cfg.update(support.SCALES[workload])
    union = inputs.build(cfg, support.SEED)
    _, joins = program.specs(union)
    seen = 0
    for j in joins:
        for n in j.nodes[1:]:
            got = build_index(n.relation, list(n.edge_attrs))
            want = ref_build_index(n.relation, list(n.edge_attrs))
            assert got.widths is None
            assert np.array_equal(got.perm, want.perm)
            assert np.array_equal(got.sorted_vals, want.sorted_vals)
            seen += 1
    assert seen >= 4
    for rel, cols in union.relations.items():
        key = [cols[a] for a in union.keys[rel]]
        got = build_index(Relation(rel, cols), list(union.keys[rel]))
        want = ref_build_index(Relation(rel, cols), list(union.keys[rel]))
        assert np.array_equal(got.sorted_vals, want.sorted_vals)
        assert np.array_equal(query_keys(got, key), combine_columns(key))


@pytest.fixture
def registry():
    fresh = obs.MetricsRegistry()
    prev = obs.set_registry(fresh)
    yield fresh
    obs.set_registry(prev)
    obs.set_tracing(None)
    obs.set_enabled(None)


def _rows_materialised(reg) -> dict:
    m = reg.get(ROWS_MATERIALISED)
    return {} if m is None else {dict(k)["join"]: v
                                 for k, v in m.snapshot().items()}


def test_materialise_span_and_rows_counter(registry):
    spec = _composite(1, "tree")
    cat = Catalog()
    want = _brute(spec)
    obs.set_tracing(True)
    before = obs.span_totals().get("warmup.materialise", {}).get("n", 0)
    full_join(cat, spec)
    assert obs.span_totals()["warmup.materialise"]["n"] == before + 1
    assert _rows_materialised(registry) == {"RS": want}
    # join_size's one step expands nothing: it keeps R's rows with a match
    r, s = (n.relation.columns for n in spec.nodes)
    keys = set(zip(s["b"].tolist(), s["c"].tolist()))
    matched = sum(k in keys for k in zip(r["b"].tolist(), r["c"].tolist()))
    join_size(cat, spec)
    assert _rows_materialised(registry) == {"RS": want + matched}
    rts = _composite(2, "residual")
    full_join(Catalog(), rts)
    steps = full_join(Catalog(), JoinSpec("RT", rts.nodes[:2]))["rid"].shape[0]
    assert _rows_materialised(registry)["RTS"] == steps + _brute(rts)


def test_materialise_tracing_off_records_nothing(registry):
    obs.set_tracing(False)
    obs.set_enabled(False)
    before = obs.span_totals().get("warmup.materialise", {}).get("n", 0)
    spec = _composite(1, "tree")
    full_join(Catalog(), spec)
    join_size(Catalog(), spec)
    assert obs.span_totals().get("warmup.materialise", {}).get("n", 0) == before
    assert registry.get(ROWS_MATERIALISED) is None


def test_device_engine_counts_residual_misses():
    """Q5's residual is keyed by suppkey (M = 1): a skeleton walk whose
    supplier is of another nation finds no residual row, which the fused
    engine counts as a residual miss, not as a lost ``Π d/M`` draw."""
    from repro_torch.core.framework import estimate_union, warmup
    from repro_torch.core.union_sampler import SetUnionSampler
    union = _q5()
    cat, joins = program.specs(union)
    cov = estimate_union(warmup(cat, joins, method="exact").oracle,
                         order=[j.name for j in joins]).cover
    s = SetUnionSampler(cat, joins, cov, seed=3, backend="torch",
                        device="cpu", round_batch=2048, plan="adaptive")
    s.sample(2048)
    st = s.stats
    assert st.residual_rejects == 0
    # uniform nations: about 24 skeleton draws in 25 miss the residual
    assert 0.85 < st.residual_misses / st.candidate_draws < 0.99
