"""Shared fixtures: tiny relational databases and workloads.

NOTE: no XLA_FLAGS here — tests must see 1 CPU device (the dry-run sets its
own device count in its own process).
"""

import numpy as np
import pytest

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.core.index import Catalog
from repro.core.joins import JoinNode, JoinSpec, chain_join
from repro.core.relation import Relation


def tiny_db(seed=0, n_r=40, n_s=60, n_t=50, dom=12):
    """Three small relations forming chains R(a,b) ⋈ S(b,c) ⋈ T(c,d)."""
    rng = np.random.default_rng(seed)
    R = Relation("R", {"a": rng.integers(0, dom, n_r),
                       "b": rng.integers(0, dom, n_r),
                       "rid": np.arange(n_r)})
    S = Relation("S", {"b": rng.integers(0, dom, n_s),
                       "c": rng.integers(0, dom, n_s),
                       "sid": np.arange(n_s)})
    T = Relation("T", {"c": rng.integers(0, dom, n_t),
                       "d": rng.integers(0, dom, n_t),
                       "tid": np.arange(n_t)})
    return R, S, T


@pytest.fixture
def cat():
    return Catalog()


@pytest.fixture
def chain_rst(cat):
    R, S, T = tiny_db()
    return chain_join("RST", [R, S, T], ["b", "c"])


def brute_force_join(spec: JoinSpec):
    """O(n^k) nested-loop join for ground truth on tiny data."""
    order = spec.expansion_order()
    rows = [dict(zip(order[0].relation.attrs, vals))
            for vals in zip(*order[0].relation.columns.values())]
    for node in order[1:]:
        rel = node.relation
        rel_rows = [dict(zip(rel.attrs, vals))
                    for vals in zip(*rel.columns.values())]
        out = []
        for r in rows:
            for s in rel_rows:
                if all(r[a] == s[a] for a in node.edge_attrs):
                    m = dict(r)
                    m.update(s)
                    out.append(m)
        rows = out
    return rows


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")
