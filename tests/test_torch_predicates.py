"""§8.3 predicates in the port against the reference, on the same arrays.

* ``compile_preds_torch`` equals ``compile_preds_jnp`` on random rows for
  every op (an empty ``in`` set included), and ``device_lower_reason``
  gives the reference's words.
* The host layer on UQ2 (both modes): workload arrays and provenance,
  ``full_join``/``join_size``/``olken_bound``, the exact and histogram
  warm-ups and covers, the exact overlaps of filtered joins; both modes
  have one exact cover.
* ``TorchTreeJoin`` under pushdown provenance draws as ``DeviceTreeJoin``
  under replayed uniforms, on UQ2's three flavours and on a chain whose
  masked-out run lies between two kept rows of one key; the flavours share
  one device tensor per base-node index and column; a stale provenance
  raises in the masked build and falls back to the filtered relations.
* ``TorchJoinMembership`` with ``reject_preds`` equals
  ``DeviceJoinMembership``.
* The union engine on UQ2 pushdown and rejection equals
  ``SetUnionSampler(backend="jax", fused_rounds="device")`` under replayed
  uniforms over three calls; its own Philox stream is uniform over the
  exact filtered union (chi-square); an unlowerable predicate raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from test_torch_support import (JaxReplay, sample_multiset, to_port,
                                tree_uniforms)

from repro.core import framework as ref_fw
from repro.core import predicates as ref_pred
from repro.core.backends.jax_backend import (DeviceJoinMembership,
                                             DeviceTreeJoin)
from repro.core.index import Catalog as RefCatalog
from repro.core.joins import chain_join as ref_chain_join
from repro.core.joins import full_join as ref_full_join
from repro.core.joins import full_join_matrix as ref_full_join_matrix
from repro.core.joins import join_size as ref_join_size
from repro.core.overlap import exact_overlap as ref_exact_overlap
from repro.core.overlap import exact_union_size as ref_exact_union_size
from repro.core.relation import Relation as RefRelation
from repro.core.size_estimation import olken_bound as ref_olken
from repro.core.union_sampler import SetUnionSampler as RefSetUnionSampler
from repro.data import workloads as ref_wl

from repro_torch import obs
from repro_torch.core import framework as pt_fw
from repro_torch.core import predicates as pt_pred
from repro_torch.core.backends.torch_backend import (TorchBackend,
                                                     TorchJoinMembership,
                                                     TorchTreeJoin)
from repro_torch.core.joins import full_join, join_size
from repro_torch.core.overlap import exact_overlap
from repro_torch.core.size_estimation import olken_bound
from repro_torch.core.union_sampler import SetUnionSampler
from repro_torch.data import workloads as pt_wl

STAT_FIELDS = ("iterations", "candidate_draws", "cover_rejects",
               "residual_rejects", "pred_rejects", "dropped_slots",
               "samples_emitted", "revisions", "backtrack_removed")
MODES = ("pushdown", "rejection")


@pytest.fixture(scope="module", params=MODES)
def uq2_pair(request):
    ref = ref_wl.uq2(scale=0.02, seed=0, pred_mode=request.param)
    pt = pt_wl.uq2(scale=0.02, seed=0, pred_mode=request.param)
    est = ref_fw.estimate_union(ref_fw.warmup(ref.cat, ref.joins,
                                              method="exact").oracle)
    return request.param, ref, pt, est


# ---------------------------------------------------------------------------
# predicate lowering
# ---------------------------------------------------------------------------


def _pred_lists(mod):
    P = mod.Pred
    return [[P("a", "==", 3)], [P("a", "!=", 3)], [P("a", "<", 5)],
            [P("a", "<=", 5)], [P("b", ">", 7)], [P("b", ">=", 7)],
            [P("a", "in", {1, 4, 9, 2**31 - 1})], [P("b", "in", set())],
            [P("a", ">=", 2), P("b", "in", range(3, 12)), P("a", "!=", 6)],
            [P("a", "<=", -(2**31)), P("b", ">", 2**31 - 1)], []]


def test_compile_preds_torch_equals_jnp():
    rng = np.random.default_rng(0)
    rows = {"a": rng.integers(0, 12, 4000).astype(np.int32),
            "b": rng.integers(0, 16, 4000).astype(np.int32)}
    rows["a"][:2] = [2**31 - 1, 0]
    for rp, pp in zip(_pred_lists(ref_pred), _pred_lists(pt_pred)):
        want = ref_pred.compile_preds_jnp(rp, ["a", "b"])(
            {k: jnp.asarray(v) for k, v in rows.items()})
        got = pt_pred.compile_preds_torch(pp, ["a", "b"])(
            {k: torch.as_tensor(v) for k, v in rows.items()})
        assert got.dtype == torch.bool
        assert np.array_equal(np.asarray(want), got.numpy()), rp
        # and the host mask of the same predicates
        assert np.array_equal(pt_pred.pred_mask_np(pp, rows),
                              ref_pred.pred_mask_np(rp, rows))


@pytest.mark.parametrize("bad", [
    ("a", "~", 3), ("a", "<", 2**31), ("a", "==", 1.5), ("a", "==", True),
    ("a", "in", 5), ("a", "in", {1, 2**40}), ("z", "==", 1), ("a", "<", None)])
def test_device_lower_reason_same_words(bad):
    want = ref_pred.device_lower_reason([ref_pred.Pred(*bad)], ["a", "b"])
    got = pt_pred.device_lower_reason([pt_pred.Pred(*bad)], ["a", "b"])
    assert want is not None and got == want
    with pytest.raises(ValueError, match="not device-lowerable"):
        pt_pred.compile_preds_torch([pt_pred.Pred(*bad)], ["a", "b"])


def test_unlowerable_predicate_raises_in_sampler(uq2_pair):
    mode, ref, _, est = uq2_pair
    cat, specs, cover = to_port(ref.joins, est.cover)
    pred = pt_pred.RejectingPredicate([pt_pred.Pred("psize", "<", 2**40)])
    reason = ref_pred.device_lower_reason(
        [ref_pred.Pred("psize", "<", 2**40)], ref.joins[0].output_attrs)
    # on a mesh it raises; without one the union degrades to the host loop
    # and records the reference's reason
    from repro_torch.core.sharding import make_sampler_mesh
    with pytest.raises(ValueError, match="not device-lowerable") as e:
        SetUnionSampler(cat, specs, cover, predicate=pred,
                        mesh=make_sampler_mesh(world=1, device="cpu"))
    assert reason in str(e.value)
    seq0 = max([e["seq"] for e in obs.fallback_events()], default=-1)
    s = SetUnionSampler(cat, specs, cover, device="cpu", predicate=pred)
    assert s.engine is None
    ev = [e for e in obs.fallback_events() if e["seq"] > seq0]
    assert [(x["reason"], x["detail"]) for x in ev] == [
        ("predicate_unsupported", reason)]


# ---------------------------------------------------------------------------
# host layer on UQ2
# ---------------------------------------------------------------------------


def test_uq2_workload_and_host_layer_equal(uq2_pair):
    mode, ref, pt, est = uq2_pair
    assert [j.name for j in pt.joins] == ["UQ2_JN", "UQ2_JP", "UQ2_JS"]
    for rj, pj in zip(ref.joins, pt.joins):
        assert [n.relation.name for n in rj.nodes] == \
            [n.relation.name for n in pj.nodes]
        for rn, pn in zip(rj.nodes, pj.nodes):
            for a, c in rn.relation.columns.items():
                assert np.array_equal(c, pn.relation.columns[a])
        for f in ("pushed_preds", "reject_preds"):
            assert [(p.attr, p.op, p.value) for p in getattr(rj, f)] == \
                [(p.attr, p.op, p.value) for p in getattr(pj, f)]
        assert (rj.pushdown_base is None) == (pj.pushdown_base is None)
        rf, pf = ref_full_join(ref.cat, rj), full_join(pt.cat, pj)
        for a in rj.output_attrs:
            assert np.array_equal(rf[a], pf[a])
        assert join_size(pt.cat, pj) == ref_join_size(ref.cat, rj)
        assert olken_bound(pt.cat, pj) == ref_olken(ref.cat, rj)
        assert pt_pred.selectivity_factor(pj) == \
            ref_pred.selectivity_factor(rj)
    for pair in ((0, 1), (0, 2), (1, 2), (0, 1, 2)):
        assert exact_overlap(pt.cat, [pt.joins[i] for i in pair]) == \
            ref_exact_overlap(ref.cat, [ref.joins[i] for i in pair])
    for method in ("exact", "histogram"):
        re_ = ref_fw.estimate_union(ref_fw.warmup(ref.cat, ref.joins,
                                                  method=method).oracle)
        pe = pt_fw.estimate_union(pt_fw.warmup(pt.cat, pt.joins,
                                               method=method).oracle)
        assert pe.cover.order == re_.cover.order
        assert pe.cover.piece_sizes == re_.cover.piece_sizes
        assert pe.cover.join_sizes == re_.cover.join_sizes
        assert pe.union_size_eq1 == re_.union_size_eq1
    # interop carries the predicates and the provenance
    cat, specs, _ = to_port(ref.joins, est.cover)
    for rj, sj in zip(ref.joins, specs):
        assert sj.pushed_preds == tuple(pt_pred.Pred(p.attr, p.op, p.value)
                                        for p in rj.pushed_preds)
        assert sj.reject_preds == tuple(pt_pred.Pred(p.attr, p.op, p.value)
                                        for p in rj.reject_preds)
        if rj.pushdown_base is not None:
            assert sj.pushdown_base is specs[0].pushdown_base
            assert [n.relation.name for n in sj.pushdown_base.nodes] == \
                [n.relation.name for n in rj.pushdown_base.nodes]


def test_both_modes_have_one_exact_cover():
    """Pushdown and rejection are one union over the same data: the port's
    exact warm-up gives both the same cover (the card run serves rejection
    mode over pushdown's exact cover)."""
    ests = [pt_fw.estimate_union(pt_fw.warmup(wl.cat, wl.joins,
                                              method="exact").oracle)
            for wl in (pt_wl.uq2(scale=0.02, seed=0, pred_mode=m)
                       for m in MODES)]
    a, b = (e.cover for e in ests)
    assert a.order == b.order
    assert a.piece_sizes == b.piece_sizes and a.join_sizes == b.join_sizes
    assert a.piece_sizes["UQ2_JP"] > 0


# ---------------------------------------------------------------------------
# tree joins under pushdown provenance
# ---------------------------------------------------------------------------


def _assert_draws_equal(ref_tree, pt_tree, seeds, batch):
    draw = jax.jit(lambda k: ref_tree.draw(k, batch))
    for seed in seeds:
        key = jax.random.PRNGKey(seed)
        r_rows, r_acc, r_ok = draw(key)
        rows, acc, ok = pt_tree.draw(tree_uniforms(key, pt_tree.n_streams,
                                                   batch))
        for a in ref_tree.attrs:
            assert np.array_equal(np.asarray(r_rows[a]), rows[a].numpy()), a
        assert np.array_equal(np.asarray(r_acc), acc.numpy())
        assert np.array_equal(np.asarray(r_ok), ok.numpy())
    return rows, acc


def test_pushdown_draws_equal_reference_and_share_indexes(uq2_pair):
    mode, ref, _, est = uq2_pair
    cat, specs, _ = to_port(ref.joins, est.cover)
    be = TorchBackend(cat, specs, device="cpu")
    trees = [be.trees[j.name] for j in specs]
    for rj, tree in zip(ref.joins, trees):
        rt = DeviceTreeJoin(ref.cat, rj, use_pallas=False)
        assert tree.masked == (mode == "pushdown")
        assert [c.uniform for c in tree.node_cfgs] == \
            [c.uniform for c in rt.node_cfgs]
        rows, acc = _assert_draws_equal(rt, tree, (0, 1, 2), 2048)
        if mode == "pushdown":
            # every accepted draw lies in the flavour's filtered join
            keep = pt_pred.pred_mask_np(
                rj.pushed_preds, {a: c.numpy() for a, c in rows.items()})
            assert keep[acc.numpy()].all()
    if mode != "pushdown":
        return
    # one device tensor per base-node index and column across the flavours
    t0 = trees[0]
    for t in trees[1:]:
        for i in range(len(t0.node_cfgs)):
            assert t.sorted_keys[i].data_ptr() == t0.sorted_keys[i].data_ptr()
            assert t.perm[i].data_ptr() == t0.perm[i].data_ptr()
            for a, c in t0.cols[i].items():
                assert t.cols[i][a].data_ptr() == c.data_ptr()
        for a, c in t0.root_cols.items():
            assert t.root_cols[a].data_ptr() == c.data_ptr()
    # the masked node really differs between flavours: its weights do
    assert not torch.equal(trees[0].wprefix[-1], trees[1].wprefix[-1])


def _masked_run_chain(mod):
    """R(a, b) ⋈_b S(b, c, sid): every key b of S holds the run c = 0, 1,
    2, 3 in row order, and the pushdown keeps c != 1 and c != 2, so a
    masked-out run of two rows lies between two kept rows of one key."""
    rng = np.random.default_rng(5)
    R = mod.Relation("R", {"a": np.arange(30), "b": rng.integers(0, 6, 30)})
    b = np.repeat(np.arange(6), 4)
    S = mod.Relation("S", {"b": b, "c": np.tile(np.arange(4), 6),
                           "sid": rng.permutation(b.size)})
    return R, S


def test_masked_run_between_kept_rows():
    from repro_torch.core.index import Catalog
    from repro_torch.core.joins import chain_join
    from repro_torch.core.relation import Relation
    import types
    ref_mod = types.SimpleNamespace(Relation=RefRelation)
    pt_mod = types.SimpleNamespace(Relation=Relation)
    R, S = _masked_run_chain(ref_mod)
    ref_spec = ref_pred.pushdown(
        ref_chain_join("RS", [R, S], ["b"]),
        [ref_pred.Pred("c", "!=", 1), ref_pred.Pred("c", "!=", 2)])
    pR, pS = _masked_run_chain(pt_mod)
    pt_spec = pt_pred.pushdown(
        chain_join("RS", [pR, pS], ["b"]),
        [pt_pred.Pred("c", "!=", 1), pt_pred.Pred("c", "!=", 2)])
    rt = DeviceTreeJoin(RefCatalog(), ref_spec, use_pallas=False)
    tree = TorchTreeJoin(Catalog(), pt_spec, device="cpu")
    assert tree.masked and not tree.node_cfgs[0].uniform
    # the masked rows' prefix region is flat after the float32 cast
    wp = tree.wprefix[0].numpy()
    skeys = tree.sorted_keys[0].numpy()
    c_sorted = S.columns["c"][tree.perm[0].numpy()]
    flat = np.isin(c_sorted, [1, 2])
    assert (wp[1:][flat] == wp[:-1][flat]).all()
    assert (skeys[:-1] <= skeys[1:]).all()
    rows, acc = _assert_draws_equal(rt, tree, range(4), 4096)
    got_c = rows["c"].numpy()[acc.numpy()]
    assert acc.numpy().all() and not np.isin(got_c, [1, 2]).any()
    assert set(got_c.tolist()) == {0, 3}


def test_stale_provenance_raises_and_falls_back():
    ref = ref_wl.uq2(scale=0.02, seed=0, pred_mode="pushdown")
    cat, specs, _ = to_port(ref.joins)
    spec = specs[0]
    stale = (pt_pred.Pred("psize", "<=", 30),)
    tree = TorchTreeJoin(cat, spec, device="cpu")
    with pytest.raises(ValueError, match="stale"):
        tree._build(cat, spec, spec.pushdown_base, stale)
    spec.pushed_preds = stale
    fallback = TorchTreeJoin(cat, spec, device="cpu")
    assert not fallback.masked
    # the same law over the filtered relations: draws match the reference's
    # own fallback on the same stale provenance
    rspec = ref.joins[0]
    saved = rspec.pushed_preds
    rspec.pushed_preds = (ref_pred.Pred("psize", "<=", 30),)
    try:
        rt = DeviceTreeJoin(ref.cat, rspec, use_pallas=False)
    finally:
        rspec.pushed_preds = saved
    _assert_draws_equal(rt, fallback, (7,), 1024)


def test_membership_with_reject_preds_equals_reference(uq2_pair):
    mode, ref, _, est = uq2_pair
    cat, specs, _ = to_port(ref.joins, est.cover)
    attrs = ref.joins[0].output_attrs
    base = ref_full_join_matrix(ref.cat, ref.joins[0].pushdown_base
                                if mode == "pushdown"
                                else ref_pred.rejection(ref.joins[0], []),
                                attrs)
    rng = np.random.default_rng(1)
    m = base[rng.integers(0, base.shape[0], 3000)].copy()
    m[::7, attrs.index("psize")] += 3           # some non-members
    rows_np = {a: m[:, i].astype(np.int32) for i, a in enumerate(attrs)}
    for rj, pj in zip(ref.joins, specs):
        want = np.asarray(DeviceJoinMembership(rj).contains(
            {a: jnp.asarray(c) for a, c in rows_np.items()}))
        got = TorchJoinMembership(pj, device="cpu").contains(
            {a: torch.as_tensor(c) for a, c in rows_np.items()}).numpy()
        assert np.array_equal(want, got), rj.name
        assert 0 < want.sum() < want.size


# ---------------------------------------------------------------------------
# the union engine on UQ2
# ---------------------------------------------------------------------------


def test_union_equals_reference_under_replayed_uniforms(uq2_pair):
    mode, ref, _, est = uq2_pair
    r = RefSetUnionSampler(ref.cat, ref.joins, est.cover, seed=3,
                           backend="jax", round_batch=512,
                           fused_rounds="device", plan="static")
    cat, specs, cover = to_port(ref.joins, est.cover)
    port = SetUnionSampler(cat, specs, cover, seed=3, device="cpu",
                           round_batch=512, uniforms=JaxReplay(3))
    assert port.engine.piece_batches == r._engine.piece_batches
    for n in (1100, 2048, 1500):
        a, b = r.sample(n), port.sample(n)
        assert np.array_equal(sample_multiset(a), sample_multiset(b))
        for f in STAT_FIELDS:
            assert getattr(a.stats, f) == getattr(b.stats, f), f
        assert np.array_equal(r._engine.piece_stats, port.engine.piece_stats)
        assert r._engine.last_rounds == port.engine.last_rounds
    assert (b.stats.pred_rejects > 0) == (mode == "rejection")
    assert b.stats.cover_rejects > 0


def test_philox_stream_uniform_over_filtered_union(uq2_pair):
    mode, ref, _, est = uq2_pair
    U = ref_exact_union_size(ref.cat, ref.joins)
    cat, specs, cover = to_port(ref.joins, est.cover)
    s = SetUnionSampler(cat, specs, cover, seed=7, device="cpu",
                        round_batch=2048)
    N = 60 * U
    ss = s.sample(N)
    m = ss.matrix()
    uni, counts = np.unique(m.view([("", m.dtype)] * m.shape[1]).ravel(),
                            return_counts=True)
    assert uni.shape[0] <= U
    exp = N / U
    chi2 = float(((counts - exp) ** 2 / exp).sum()) + (U - uni.shape[0]) * exp
    p = 1 - sps.chi2.cdf(chi2, df=U - 1)
    assert p > 1e-3, f"port not uniform over UQ2/{mode} (p={p})"
    # every row passes its home piece's predicates and lies in no earlier
    # piece (the oracle applies reject_preds)
    for j, spec in enumerate(ref.joins):
        sel = ss.home == j
        preds = tuple(spec.reject_preds) + tuple(spec.pushed_preds)
        rows = {a: ss.rows[a][sel] for a in ss.attrs}
        assert ref_pred.pred_mask_np(preds, rows).all(), spec.name
    mm = s.prober.membership_matrix(ss.rows, s.order)
    assert mm.any(axis=1).all()
    assert np.array_equal(np.argmax(mm, axis=1), ss.home)
    if mode == "rejection":
        assert ss.stats.pred_rejects > 0
