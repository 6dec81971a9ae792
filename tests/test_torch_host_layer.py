"""The port's numpy host layer equals the reference exactly.

Same seed → the same TPC-H-lite arrays, vertical and horizontal splits, EW
node weights and root prefix, §5 histogram overlap bounds, Olken bounds,
cover order and selection probabilities; and ``workload_from_numpy``
round-trips a reference workload.
All comparisons are exact (the port runs the same numpy arithmetic).
"""

import itertools

import numpy as np
import pytest

from conftest import tiny_db
from test_torch_support import to_port

from repro.core import framework as ref_fw
from repro.core.join_sampler import JoinSampler as RefJoinSampler
from repro.core.joins import chain_join as ref_chain_join
from repro.core.index import Catalog as RefCatalog
from repro.core.overlap import HistogramOverlap as RefHist
from repro.core.size_estimation import olken_bound as ref_olken
from repro.data import tpch as ref_tpch
from repro.data import workloads as ref_wl

from repro_torch.core import framework as pt_fw
from repro_torch.core.join_sampler import JoinSampler
from repro_torch.core.overlap import HistogramOverlap
from repro_torch.core.size_estimation import olken_bound
from repro_torch.data import tpch as pt_tpch
from repro_torch.data import workloads as pt_wl

WORKLOADS = {
    "uq1": lambda m: m.uq1(scale=0.05, overlap=0.4, seed=1),
    "uq3": lambda m: m.uq3(seed=3),
    "uq4": lambda m: m.uq4(scale=0.05, seed=2),
}


@pytest.fixture(scope="module", params=sorted(WORKLOADS))
def pair(request):
    make = WORKLOADS[request.param]
    return make(ref_wl), make(pt_wl)


def _tiny_chains():
    """Two conftest chains sharing S and T: a small union on both sides."""
    R, S, T = tiny_db(0)
    R2 = R.filter(np.arange(R.nrows) % 3 != 0, name="R2")
    return [ref_chain_join("RST", [R, S, T], ["b", "c"]),
            ref_chain_join("R2ST", [R2, S, T], ["b", "c"])]


def test_workload_arrays_equal(pair):
    ref, pt = pair
    assert [j.name for j in ref.joins] == [j.name for j in pt.joins]
    for rj, pj in zip(ref.joins, pt.joins):
        assert rj.output_attrs == pj.output_attrs
        for rn, pn in zip(rj.nodes, pj.nodes):
            assert (rn.alias, rn.parent, rn.edge_attrs, rn.kind) == \
                (pn.alias, pn.parent, pn.edge_attrs, pn.kind)
            assert rn.relation.name == pn.relation.name
            assert rn.relation.attrs == pn.relation.attrs
            for a in rn.relation.attrs:
                assert np.array_equal(rn.relation.columns[a],
                                      pn.relation.columns[a]), (rn.alias, a)


def test_split_helpers_equal():
    rel = ref_tpch.generate(0.05, seed=4)["orders"]
    groups, key = [["ck"], [], ["odate", "ck"]], ["ok"]
    pairs = list(zip(ref_tpch.vertical_split(rel, groups, key),
                     pt_tpch.vertical_split(rel, groups, key)))
    for frac, seed, name in ((0.3, 5, None), (0.8, 6, "kept")):
        pairs.append((ref_tpch.horizontal_split(rel, frac, seed, name),
                      pt_tpch.horizontal_split(rel, frac, seed, name)))
    assert [r.attrs for r, _ in pairs[:3]] == [
        ["ok", "ck"], ["ok"], ["ok", "odate", "ck"]]
    assert 0 < pairs[3][0].nrows < rel.nrows
    for r, p in pairs:
        assert (r.name, r.attrs, r.nrows) == (p.name, p.attrs, p.nrows)
        for a in r.attrs:
            assert np.array_equal(r.columns[a], p.columns[a]), (r.name, a)


def test_ew_weights_and_root_prefix_equal(pair):
    ref, pt = pair
    for rj, pj in zip(ref.joins, pt.joins):
        r = RefJoinSampler(ref.cat, rj, method="ew")
        p = JoinSampler(pt.cat, pj)
        assert r.node_weights.keys() == p.node_weights.keys()
        for k in r.node_weights:
            assert np.array_equal(r.node_weights[k], p.node_weights[k]), k
        assert np.array_equal(r.root_weight_prefix, p.root_weight_prefix)
        for alias, plan in r.edges.items():
            assert plan.max_degree == p.edges[alias].max_degree
            assert np.array_equal(plan.index.perm, p.edges[alias].index.perm)


def test_histogram_overlap_and_olken_equal(pair):
    ref, pt = pair
    rh = RefHist(ref.cat, ref.joins)
    ph = HistogramOverlap(pt.cat, pt.joins)
    for rj, pj in zip(ref.joins, pt.joins):
        assert ref_olken(ref.cat, rj) == olken_bound(pt.cat, pj)
    for k in range(1, len(ref.joins) + 1):
        for idx in itertools.combinations(range(len(ref.joins)), k):
            assert rh.estimate([ref.joins[i] for i in idx]) == \
                ph.estimate([pt.joins[i] for i in idx]), idx


@pytest.mark.parametrize("method", ["histogram", "exact"])
def test_cover_equal(pair, method):
    ref, pt = pair
    r = ref_fw.estimate_union(ref_fw.warmup(ref.cat, ref.joins,
                                            method=method).oracle)
    p = pt_fw.estimate_union(pt_fw.warmup(pt.cat, pt.joins,
                                          method=method).oracle)
    assert r.cover.order == p.cover.order
    assert r.cover.piece_sizes == p.cover.piece_sizes
    assert r.cover.selection_probs() == p.cover.selection_probs()
    assert r.union_size_eq1 == p.union_size_eq1


def test_tiny_chains_cover_and_weights():
    joins = _tiny_chains()
    cat, specs, _ = to_port(joins)
    r = ref_fw.estimate_union(ref_fw.warmup(RefCatalog(), joins,
                                            method="exact").oracle)
    p = pt_fw.estimate_union(pt_fw.warmup(cat, specs, method="exact").oracle)
    assert r.cover.piece_sizes == p.cover.piece_sizes
    assert r.koverlaps.a == p.koverlaps.a
    for rj, pj in zip(joins, specs):
        a = RefJoinSampler(RefCatalog(), rj, method="ew")
        b = JoinSampler(cat, pj)
        assert np.array_equal(a.root_weight_prefix, b.root_weight_prefix)


def test_workload_from_numpy_roundtrip(pair):
    ref, _ = pair
    est = ref_fw.estimate_union(ref_fw.warmup(ref.cat, ref.joins,
                                              method="histogram").oracle)
    cat, specs, cover = to_port(ref.joins, est.cover)
    assert cover.order == est.cover.order
    assert cover.piece_sizes == est.cover.piece_sizes
    assert cover.join_sizes == est.cover.join_sizes
    assert cover.selection_probs() == est.cover.selection_probs()
    for rj, pj in zip(ref.joins, specs):
        assert rj.name == pj.name and rj.output_attrs == pj.output_attrs
        assert [n.alias for n in rj.expansion_order()] == \
            [n.alias for n in pj.expansion_order()]
        for rn, pn in zip(rj.nodes, pj.nodes):
            for a in rn.relation.attrs:
                assert np.array_equal(rn.relation.columns[a],
                                      pn.relation.columns[a])
    # relations shared by name stay one object across the port's joins
    by_name = {}
    for pj in specs:
        for n in pj.nodes:
            assert by_name.setdefault(n.relation.name, n.relation) is n.relation
