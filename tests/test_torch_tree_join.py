"""TorchTreeJoin draws equal DeviceTreeJoin draws under the same uniforms.

The uniforms come from the reference's key schedule (``split(key,
n_nodes+1[+1])`` + ``uniform``), so rows, ``accept`` and ``walk_ok`` must
match element for element: UQ1 (weighted and uniform nodes), UQ3 (a
branching tree: ``cust_a`` has two children), UQ4 (a §8.2 residual node), a
cyclic spec whose residual degrees vary (``Π d/M`` with M > 1), and a
conftest chain also against the Pallas interpret path.  A
chi-square pins the port's own draws to the exact join.
"""

import jax
import numpy as np
import pytest
import torch
from scipy import stats as sps

from conftest import tiny_db
from test_torch_support import to_port, tree_uniforms

from repro.core.backends.jax_backend import DeviceTreeJoin
from repro.core.index import Catalog
from repro.core.joins import JoinNode, JoinSpec, chain_join, full_join_matrix
from repro.core.relation import Relation
from repro.data.workloads import uq1, uq3, uq4

from repro_torch.core.backends.torch_backend import TorchTreeJoin


def _cyclic_spec(seed=0, n_q=40):
    """R(a,b) ⋈_b S(b,c) skeleton + residual Q(a,c) with multiplicities
    {1, 2, 4} (pairs may repeat): the residual degree d varies, M > 1."""
    R, S, _ = tiny_db(seed)
    rng = np.random.default_rng(seed + 1)
    a = rng.integers(0, 12, n_q)
    c = rng.integers(0, 12, n_q)
    mult = rng.choice([1, 2, 4], size=n_q, p=[0.5, 0.3, 0.2])
    mult[0] = 4
    Q = Relation("Q", {"a": np.repeat(a, mult), "c": np.repeat(c, mult),
                       "qid": np.arange(int(mult.sum()))})
    return Catalog(), JoinSpec("CYC", [
        JoinNode("R", R, None, ()),
        JoinNode("S", S, "R", ("b",)),
        JoinNode("Q", Q, None, ("a", "c"), kind="residual"),
    ])


def _chain_spec():
    R, S, T = tiny_db(0)
    return Catalog(), chain_join("RST", [R, S, T], ["b", "c"])


def _assert_draws_equal(ref_tree, pt_tree, keys, batch):
    draw = jax.jit(lambda k: ref_tree.draw(k, batch))
    for key in keys:
        r_rows, r_acc, r_ok = draw(key)
        rows, acc, ok = pt_tree.draw(tree_uniforms(key, pt_tree.n_streams,
                                                   batch))
        for a in ref_tree.attrs:
            assert np.array_equal(np.asarray(r_rows[a]), rows[a].numpy()), a
        assert np.array_equal(np.asarray(r_acc), acc.numpy())
        assert np.array_equal(np.asarray(r_ok), ok.numpy())


@pytest.mark.parametrize("wl_name", ["uq1", "uq3", "uq4", "cyclic"])
def test_draws_equal_reference(wl_name):
    if wl_name == "uq1":
        wl = uq1(scale=0.05, overlap=0.4, seed=0)
        joins, cat_ref = wl.joins[:2], wl.cat
    elif wl_name == "uq3":
        wl = uq3()
        joins, cat_ref = wl.joins, wl.cat
        parents = [n.parent for n in joins[0].nodes]
        assert parents.count("cust_a") == 2          # a branching node
    elif wl_name == "uq4":
        wl = uq4(scale=0.05, seed=0)
        joins, cat_ref = wl.joins, wl.cat
    else:
        cat_ref, spec = _cyclic_spec()
        joins = [spec]
    cat, specs, _ = to_port(joins)
    keys = [jax.random.PRNGKey(s) for s in (11, 12)]
    for rj, pj in zip(joins, specs):
        ref_tree = DeviceTreeJoin(cat_ref, rj, use_pallas=False)
        pt_tree = TorchTreeJoin(cat, pj, device="cpu")
        kinds = {(c.kind, c.uniform) for c in pt_tree.node_cfgs}
        if wl_name == "uq1":
            assert ("tree", True) in kinds and ("tree", False) in kinds
        if wl_name == "uq3":
            # every edge of a vertical split is 1:1: all nodes run probe_pick
            assert kinds == {("tree", True)}
        if wl_name == "cyclic":
            assert pt_tree.node_cfgs[-1].max_degree > 1
        _assert_draws_equal(ref_tree, pt_tree, keys, 1024)


def test_draws_equal_pallas_interpret_path():
    cat_ref, spec = _chain_spec()
    cat, (pspec,), _ = to_port([spec])
    ref_tree = DeviceTreeJoin(cat_ref, spec, use_pallas=True)
    pt_tree = TorchTreeJoin(cat, pspec, device="cpu")
    _assert_draws_equal(ref_tree, pt_tree, [jax.random.PRNGKey(5)], 256)


def test_residual_rejections_present():
    """The cyclic spec rejects some walks through Π d/M (accept ⊂ walk_ok)."""
    _, spec = _cyclic_spec()
    cat, (pspec,), _ = to_port([spec])
    tree = TorchTreeJoin(cat, pspec, device="cpu")
    g = torch.Generator().manual_seed(0)
    _, acc, ok = tree.draw(torch.rand((tree.n_streams, 4096), generator=g))
    assert bool((acc <= ok).all())
    assert int((ok & ~acc).sum()) > 0


@pytest.mark.parametrize("which", ["chain", "cyclic"])
def test_port_draws_uniform_over_exact_join(which):
    cat_ref, spec = _chain_spec() if which == "chain" else _cyclic_spec()
    cat, (pspec,), _ = to_port([spec])
    tree = TorchTreeJoin(cat, pspec, device="cpu")
    g = torch.Generator().manual_seed(3)
    attrs = list(tree.attrs)
    mats = []
    for _ in range(8):
        rows, acc, _ = tree.draw(torch.rand((tree.n_streams, 8192),
                                            generator=g))
        mats.append(np.stack([rows[a][acc].numpy() for a in attrs], axis=1))
    got = np.concatenate(mats).astype(np.int64)
    universe = full_join_matrix(cat_ref, spec, attrs)

    def keyed(m):
        return np.ascontiguousarray(m).view([("", m.dtype)] * m.shape[1]).ravel()
    uni, exp_counts = np.unique(keyed(universe), return_counts=True)
    s_uni, s_counts = np.unique(keyed(got), return_counts=True)
    assert np.isin(s_uni, uni).all(), "sampled a tuple outside the join"
    counts = np.zeros(uni.shape[0])
    counts[np.searchsorted(uni, s_uni)] = s_counts
    exp = got.shape[0] * exp_counts / exp_counts.sum()
    p = 1 - sps.chi2.cdf(float(((counts - exp) ** 2 / exp).sum()),
                         df=uni.shape[0] - 1)
    assert p > 1e-3, f"port draws not uniform over {which} (p={p})"
