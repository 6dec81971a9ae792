"""The port's estimators against the reference's (``repro.core.estimators``).

With the walk and round uniforms replayed from the reference's JAX key
schedule (``JaxWalkReplay``, ``JaxSourceReplay``):

* ``TorchWalkJoin`` draws equal ``DeviceWalkJoin.draw`` exactly (rows,
  float32 ``prob``, ``ok``) on two chains, a branching tree (UQ3) and a
  cyclic join whose residual edge is a plain hop (UQ4), and equal the Pallas
  walk hop (``use_pallas=True``, interpret mode);
* the HT accumulators hold to the reference's float32 ``DeviceRunning``:
  counts exact, means within rel 1e-5, M2 and half-widths within rel 1e-4;
* ``TorchEstimator.observe`` / ``estimate`` / ``join_size`` give the same
  pools (exact), counts and walk counts (exact) and means (rel 1e-5);
* ``TorchHistogramOverlap`` equals ``DeviceHistogramOverlap`` (rel 1e-6),
  the port's ``HistogramOverlap(mode="avg")`` the reference's (exact);
* ``TorchCandidateSource`` serves the same rows, draw counts and residual
  rejections as ``JaxCandidateSource`` across refill boundaries;
* ``warmup(method="random_walk")`` gives the same oracle, the §8.3 scaling
  included; ``WanderJoinSizeEstimator`` the same trajectory.
"""

import itertools

import jax
import numpy as np
import pytest
import torch

from conftest import tiny_db
from test_torch_support import (JaxSourceReplay, JaxWalkReplay, to_port)
from test_torch_tree_join import _cyclic_spec

from repro.core.backends.jax_backend import DeviceTreeJoin, JaxCandidateSource
from repro.core.estimators import ReservoirPool as RefPool
from repro.core.estimators.jax_estimator import (DeviceHistogramOverlap,
                                                 DeviceRunning,
                                                 DeviceWalkJoin, JaxEstimator)
from repro.core.estimators.jax_estimator import (
    _batch_moments as ref_batch_moments,
    _merge_moments as ref_merge_moments)
from repro.core.framework import estimate_union as ref_estimate_union
from repro.core.framework import warmup as ref_warmup
from repro.core.index import Catalog
from repro.core.joins import chain_join
from repro.core.overlap import HistogramOverlap as RefHistogramOverlap
from repro.core.size_estimation import RunningMean as RefRunningMean
from repro.core.size_estimation import \
    WanderJoinSizeEstimator as RefWanderJoin
from repro.data.tpch import make_variants
from repro.data.workloads import uq1, uq2, uq3, uq4

from repro_torch.core.backends.torch_backend import (TorchCandidateSource,
                                                     TorchTreeJoin)
from repro_torch.core.estimators import (EstimatorBackend, NumpyEstimator,
                                         ReservoirPool, TorchEstimator,
                                         get_estimator)
from repro_torch.core.estimators.torch_estimator import (
    TorchHistogramOverlap, TorchRunning, TorchWalkJoin, _batch_moments,
    _merge_moments)
from repro_torch.core.framework import estimate_union, warmup
from repro_torch.core.join_sampler import EmptyJoinError
from repro_torch.core.overlap import HistogramOverlap
from repro_torch.core.size_estimation import (RunningMean,
                                              WanderJoinSizeEstimator,
                                              z_value)


def _two_chains(seed=0, overlap=0.5):
    """Two chain joins over variant relations with controlled overlap (the
    reference tests' ``_two_chains``)."""
    R, S, T = tiny_db(seed, n_r=80, n_s=90, n_t=70)
    cat = Catalog()
    Rv = make_variants(R, 2, overlap, seed=seed + 10)
    Sv = make_variants(S, 2, overlap, seed=seed + 11)
    Tv = make_variants(T, 2, overlap, seed=seed + 12)
    j0 = chain_join("J0", [Rv[0], Sv[0], Tv[0]], ["b", "c"])
    j1 = chain_join("J1", [Rv[1], Sv[1], Tv[1]], ["b", "c"])
    return cat, [j0, j1]


def _workload(name):
    if name == "two_chains":
        return _two_chains(1, overlap=0.6)
    if name == "uq3":
        wl = uq3()
        return wl.cat, wl.joins
    wl = uq4(scale=0.05, seed=0)
    return wl.cat, wl.joins


def _walk_key(seed):
    """The key the first ``JaxWalkReplay(seed).walk`` call draws from."""
    return jax.random.split(jax.random.PRNGKey(seed))[1]


def _assert_walks_equal(ref, port_rows, port_prob, port_ok, attrs):
    r_rows, r_prob, r_ok = ref
    for a in attrs:
        assert np.array_equal(np.asarray(r_rows[a]), port_rows[a].numpy()), a
    assert np.asarray(r_prob).dtype == np.float32
    assert port_prob.dtype == torch.float32
    assert np.array_equal(np.asarray(r_prob), port_prob.numpy())
    assert np.array_equal(np.asarray(r_ok), port_ok.numpy())


# ---------------------------------------------------------------------------
# walks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["two_chains", "uq3", "uq4"])
def test_walks_equal_reference_under_replay(name):
    cat, joins = _workload(name)
    pcat, pspecs, _ = to_port(joins)
    for seed, (spec, pspec) in enumerate(zip(joins, pspecs)):
        ref = DeviceWalkJoin(cat, spec, use_pallas=False)
        port = TorchWalkJoin(pcat, pspec, device="cpu")
        assert port.n_hops == len(ref.sorted_keys) and port.n_root == ref.n_root
        batch = 300
        want = jax.jit(lambda k: ref.draw(k, batch))(_walk_key(seed))
        r_pos, u = JaxWalkReplay(seed).walk(port.n_root, port.n_hops, batch)
        rows, prob, ok = port.draw(r_pos, u)
        _assert_walks_equal(want, rows, prob, ok, spec.output_attrs)
        assert bool(ok.any())
        if name == "uq4" and spec.is_cyclic:
            # the residual edge is a plain hop: some walks die there, none
            # is rejected by a d/M test
            assert port.node_edge_attrs[-1] == ("pk", "sk")


def test_walks_equal_pallas_walk_hop():
    R, S, T = tiny_db(3)
    cat = Catalog()
    spec = chain_join("RST", [R, S, T], ["b", "c"])
    ref = DeviceWalkJoin(cat, spec, use_pallas=True)
    want = jax.jit(lambda k: ref.draw(k, 256))(_walk_key(0))
    pcat, (pspec,), _ = to_port([spec])
    port = TorchWalkJoin(pcat, pspec, device="cpu")
    rows, prob, ok = port.draw(*JaxWalkReplay(0).walk(port.n_root,
                                                      port.n_hops, 256))
    _assert_walks_equal(want, rows, prob, ok, spec.output_attrs)


def test_walk_rejects_domain_overflow():
    from repro_torch.core.joins import JoinNode, JoinSpec
    from repro_torch.core.index import Catalog as PortCatalog
    from repro_torch.core.relation import Relation
    big = 1 << 16
    A = Relation("A", {"x": np.array([0, big]), "y": np.array([0, big])})
    B = Relation("B", {"x": np.array([0, big]), "y": np.array([big, 0]),
                       "z": np.array([1, 2])})
    spec = JoinSpec("BIG", [JoinNode("A", A, None, ()),
                            JoinNode("B", B, "A", ("x", "y"))])
    with pytest.raises(ValueError, match="exceeds int32"):
        TorchWalkJoin(PortCatalog(), spec, device="cpu")


# ---------------------------------------------------------------------------
# accumulators
# ---------------------------------------------------------------------------


def test_accumulators_match_reference_on_heavy_tailed_trace():
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    # heavy-tailed draws like 1/p(t): spread over 6 orders of magnitude
    xs = (10.0 ** rng.uniform(0, 6, 4096)) * (rng.random(4096) < 0.7)
    ref, port, host = DeviceRunning(), TorchRunning("cpu"), RunningMean()
    ref_host = RefRunningMean()
    for lo in range(0, xs.shape[0], 512):
        b = xs[lo:lo + 512]
        ref.state = ref_merge_moments(
            *ref.state, *ref_batch_moments(jnp.asarray(b, jnp.float32)))
        port.state = _merge_moments(
            *port.state, *_batch_moments(torch.as_tensor(b, dtype=torch.float32)))
        host.update_batch(b)
        ref_host.update_batch(b)
        assert port.count == ref.count
        assert port.mean == pytest.approx(ref.mean, rel=1e-5)
        assert port.m2 == pytest.approx(ref.m2, rel=1e-4)
        assert port.half_width(0.90) == pytest.approx(ref.half_width(0.90),
                                                      rel=1e-4)
    assert port.state[0].dtype == torch.int32
    assert port.state[1].dtype == port.state[2].dtype == torch.float32
    assert port.count == host.count == 4096
    # the port's host Welford copy is the reference's, bit for bit
    assert (host.count, host.mean, host.m2) == (ref_host.count, ref_host.mean,
                                                ref_host.m2)
    assert host.half_width(0.90) == ref_host.half_width(0.90)
    assert port.mean == pytest.approx(host.mean, rel=1e-4)
    port.update_zeros(512)
    ref.update_zeros(512)
    assert port.count == ref.count and port.mean == pytest.approx(ref.mean,
                                                                   rel=1e-5)
    assert TorchRunning("cpu").half_width() == float("inf")
    assert z_value(0.90) == 1.6449 and z_value(0.975) == pytest.approx(2.24,
                                                                        abs=0.01)


# ---------------------------------------------------------------------------
# observe / estimate / join_size
# ---------------------------------------------------------------------------


def _pair(seed=4, batch=256, **kw):
    cat, joins = _two_chains(2, overlap=0.7)
    pcat, pspecs, _ = to_port(joins)
    ref = JaxEstimator(cat, joins, seed=seed, batch=batch, **kw)
    port = TorchEstimator(pcat, pspecs, seed=seed, batch=batch, device="cpu",
                          uniforms=JaxWalkReplay(seed), **kw)
    return ref, port, joins, pspecs


def _assert_stats_close(ref_stats, port_stats):
    assert set(ref_stats) == set(port_stats)
    for k in ref_stats:
        a, b = ref_stats[k], port_stats[k]
        assert a.count == b.count, k
        assert b.mean == pytest.approx(a.mean, rel=1e-5), k


def test_observe_equals_reference_over_one_and_two_joins():
    ref, port, joins, pspecs = _pair()
    for delta in ([0], [1], [0, 1], [0, 1], [1]):
        a = ref.observe([joins[i] for i in delta], rounds=2)
        b = port.observe([pspecs[i] for i in delta], rounds=2)
        assert a.walks == b.walks
        assert b.value == pytest.approx(a.value, rel=1e-5)
        assert b.half_width == pytest.approx(a.half_width, rel=1e-4)
    _assert_stats_close(ref.size_stats, port.size_stats)
    _assert_stats_close(ref.overlap_stats, port.overlap_stats)
    rp, pp = ref.drain_pool(), port.drain_pool()
    assert set(rp) == set(pp) and port.walk_pool == {}
    for name in rp:
        assert len(rp[name]) == len(pp[name])
        for (r_rows, r_prob), (p_rows, p_prob) in zip(rp[name], pp[name]):
            assert p_prob.dtype == np.float64 and np.array_equal(r_prob, p_prob)
            for a in r_rows:
                assert p_rows[a].dtype == np.int64
                assert np.array_equal(r_rows[a], p_rows[a])
    assert any((p > 0).any() for _, p in pp["J0"])


def test_estimate_and_join_size_stop_at_the_same_walk_counts():
    ref, port, joins, pspecs = _pair(seed=6, batch=128)
    a = ref.estimate(joins, rel_halfwidth=0.2, max_walks=4096, min_walks=512)
    b = port.estimate(pspecs, rel_halfwidth=0.2, max_walks=4096, min_walks=512)
    assert a.walks == b.walks and a.walks >= 512
    assert b.value == pytest.approx(a.value, rel=1e-5)
    for j, pj in zip(joins, pspecs):
        assert port.join_size(pj, min_walks=1024) == pytest.approx(
            ref.join_size(j, min_walks=1024), rel=1e-5)
        assert port.size_stats[pj.name].count == ref.size_stats[j.name].count
    assert port.name == "torch" and isinstance(port, EstimatorBackend)


def test_empty_join_branch():
    R, S, T = tiny_db(0)
    S_empty = S.filter(np.zeros(S.nrows, dtype=bool), name="S_empty")
    spec = chain_join("EMPTY", [R, S_empty, T], ["b", "c"])
    ref = JaxEstimator(Catalog(), [spec], seed=0, batch=256)
    pcat, (pspec,), _ = to_port([spec])
    replay = JaxWalkReplay(0)
    port = TorchEstimator(pcat, [pspec], seed=0, batch=256, device="cpu",
                          uniforms=replay)
    key0 = replay.key
    a, b = ref.observe([spec], rounds=2), port.observe([pspec], rounds=2)
    assert b.value == a.value == 0.0 and b.walks == a.walks == 512
    assert port.size_stats["EMPTY"].count == 512
    assert port.join_size(pspec, min_walks=256) == 0.0
    assert port.walk_pool == {}
    assert np.array_equal(np.asarray(replay.key), np.asarray(key0))  # no draw


def test_reservoir_pool_bit_equal_with_cap_engaged():
    rng = np.random.default_rng(1)
    ref, port = RefPool(cap=3, seed=5), ReservoirPool(cap=3, seed=5)
    for i in range(60):
        b = ({"x": rng.integers(0, 9, 4)}, rng.random(4))
        name = "J" if i % 3 else "K"
        ref.add(name, b)
        port.add(name, b)
    for name in ("J", "K"):
        assert port.n_batches(name) == ref.n_batches(name) == 3
        assert [id(b) for b in port.pools[name]] == \
            [id(b) for b in ref.pools[name]]
    assert ref._rng.random() == port._rng.random()
    with pytest.raises(ValueError):
        ReservoirPool(cap=0)


def test_get_estimator_routing():
    cat, joins = _two_chains(0)
    pcat, pspecs, _ = to_port(joins)
    est = get_estimator("torch", pcat, pspecs, seed=0, batch=64, device="cpu")
    assert isinstance(est, TorchEstimator) and est.batch == 64
    assert get_estimator(est, pcat, pspecs) is est
    host = get_estimator("numpy", pcat, pspecs, seed=0, batch=64, pool_cap=8)
    assert isinstance(host, NumpyEstimator) and host._pool.cap == 8
    for bad in ("jax", "gpu"):
        with pytest.raises(ValueError, match="unknown estimator backend"):
            get_estimator(bad, pcat, pspecs, device="cpu")


# ---------------------------------------------------------------------------
# histogram overlap
# ---------------------------------------------------------------------------


def test_histogram_overlaps_equal_reference():
    wl = uq3(scale=0.01, overlap=0.3, seed=0)
    pcat, pspecs, _ = to_port(wl.joins)
    deltas = [r for k in (1, 2, 3) for r in itertools.combinations(range(3), k)]
    for mode in ("max", "avg"):
        ref_dev = DeviceHistogramOverlap(wl.cat, wl.joins, mode=mode)
        ref_host = RefHistogramOverlap(wl.cat, wl.joins, mode=mode)
        port_dev = TorchHistogramOverlap(pcat, pspecs, mode=mode, device="cpu")
        port_host = HistogramOverlap(pcat, pspecs, mode=mode)
        for d in deltas:
            want = ref_dev.estimate([wl.joins[i] for i in d])
            got = port_dev.estimate([pspecs[i] for i in d])
            assert got == pytest.approx(want, rel=1e-6), (mode, d)
            assert port_host.estimate([pspecs[i] for i in d]) == \
                ref_host.estimate([wl.joins[i] for i in d]), (mode, d)
    # no cap: the Theorem-4 value itself
    ref_nc = RefHistogramOverlap(wl.cat, wl.joins, cap_with_join_bound=False)
    port_nc = HistogramOverlap(pcat, pspecs, cap_with_join_bound=False)
    assert port_nc.estimate(pspecs) == ref_nc.estimate(wl.joins)
    est = TorchEstimator(pcat, pspecs, device="cpu")
    assert isinstance(est.histogram("avg"), TorchHistogramOverlap)
    with pytest.raises(ValueError, match="mode"):
        HistogramOverlap(pcat, pspecs, mode="min")


# ---------------------------------------------------------------------------
# candidate source
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["uq4", "cyclic"])
def test_candidate_source_equals_reference(name):
    if name == "uq4":
        wl = uq4(scale=0.05, seed=0)
        cat, spec = wl.cat, wl.joins[0]
    else:
        cat, spec = _cyclic_spec()
    assert spec.is_cyclic
    ref = JaxCandidateSource(DeviceTreeJoin(cat, spec, use_pallas=False),
                             seed=11, device_batch=256)
    pcat, (pspec,), _ = to_port([spec])
    port = TorchCandidateSource(TorchTreeJoin(pcat, pspec, device="cpu"),
                                device_batch=256, uniforms=JaxSourceReplay(11))
    rng = np.random.default_rng(0)
    res_total = 0
    for count in (1, 1, 90, 300, 1, 513, 40, 1, 700):
        a_rows, a_draws = ref.draw(rng, count)
        b_rows, b_draws = port.draw(None, count)
        assert a_draws == b_draws, count
        for a in ref.attrs:
            assert b_rows[a].dtype == np.int64
            assert np.array_equal(a_rows[a], b_rows[a]), (count, a)
        r = ref.pop_residual_rejects()
        assert port.pop_residual_rejects() == r
        res_total += r
    if name == "cyclic":
        assert res_total > 0


def test_candidate_source_empty_join_raises():
    R, S, T = tiny_db(0)
    S_empty = S.filter(np.zeros(S.nrows, dtype=bool), name="S_empty")
    pcat, (pspec,), _ = to_port([chain_join("EMPTY", [R, S_empty, T],
                                            ["b", "c"])])
    src = TorchCandidateSource(TorchTreeJoin(pcat, pspec, device="cpu"))
    with pytest.raises(EmptyJoinError):
        src.draw(None, 1)


# ---------------------------------------------------------------------------
# random-walk warm-up and the size estimator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["uq1", "uq2_rejection"])
def test_random_walk_warmup_equals_reference(name):
    if name == "uq1":
        wl = uq1(scale=0.05, overlap=0.4, seed=0, n_joins=3)
    else:
        wl = uq2(scale=0.05, seed=0, pred_mode="rejection")
        assert all(j.reject_preds for j in wl.joins)
    kw = dict(method="random_walk", seed=2, rw_batch=256, rw_max_walks=2048)
    ref = ref_warmup(wl.cat, wl.joins, backend="jax", **kw)
    pcat, pspecs, _ = to_port(wl.joins)
    port = warmup(pcat, pspecs, device="cpu", uniforms=JaxWalkReplay(2), **kw)
    assert isinstance(port.aux, TorchEstimator)
    a, b = ref_estimate_union(ref.oracle), estimate_union(port.oracle)
    for j, pj in zip(wl.joins, pspecs):
        assert port.oracle.size(pj.name) == pytest.approx(
            ref.oracle.size(j.name), rel=1e-5)
    for d in [r for k in (2, 3) for r in itertools.combinations(
            [j.name for j in wl.joins], k)]:
        assert port.oracle.overlap(d) == pytest.approx(ref.oracle.overlap(d),
                                                       rel=1e-5, abs=1e-9)
    for k in ref.aux.overlap_stats:
        assert port.aux.overlap_stats[k].count == ref.aux.overlap_stats[k].count
    assert b.union_size_cover == pytest.approx(a.union_size_cover, rel=1e-5)
    assert b.union_size_cover > 0


def test_wander_join_size_estimator_equals_reference():
    R, S, T = tiny_db(3)
    spec = chain_join("RST", [R, S, T], ["b", "c"])
    ref = RefWanderJoin(Catalog(), spec, seed=0, batch=512, backend="jax")
    pcat, (pspec,), _ = to_port([spec])
    port = WanderJoinSizeEstimator(pcat, pspec, seed=0, batch=512,
                                   device="cpu", uniforms=JaxWalkReplay(0))
    for _ in range(4):
        (ea, ha), (eb, hb) = ref.step(), port.step()
        assert eb == pytest.approx(ea, rel=1e-5)
        assert hb == pytest.approx(ha, rel=1e-4)
    assert port.walks == ref.walks == 2048
    assert port.run(rel_halfwidth=0.05, max_walks=8192) == pytest.approx(
        ref.run(rel_halfwidth=0.05, max_walks=8192), rel=1e-5)
    assert port.walks == ref.walks
    assert port.estimate == pytest.approx(ref.estimate, rel=1e-5)
    for bad in ("numpy", "jax"):
        with pytest.raises(ValueError, match="backend"):
            WanderJoinSizeEstimator(pcat, pspec, backend=bad, device="cpu")
