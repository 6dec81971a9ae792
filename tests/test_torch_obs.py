"""The port's telemetry (``repro_torch.obs``) against the reference's.

Mirrors ``tests/test_obs.py`` on the port's own registry:

* metrics core — get-or-create and kind conflicts, labeled children,
  thread-safe increments, quantile interpolation, Prometheus exposition and
  the ``REPRO_OBS`` kill switch; the same operations on the port's and the
  reference's registries render the same exposition text;
* :class:`TraceRing` bounded wrap with monotone sequence numbers;
* :class:`MetricsServer` ``/metrics`` + ``/healthz``;
* ``SamplerStats.merge``/``snapshot``;
* the engine: samples bit-identical with telemetry on and off and between
  the two loop modes, ``piece_stats`` tying out to ``candidate_draws`` and
  to the registry's per-join series under the reference's names, the round
  and sample counters, ``record_fallback``;
* the serve tier's merged accounting under concurrent requesters and its
  request series (collector removed on ``stop()``), the kill switch;
* ONLINE-UNION's refinement series.

The capture of the round as a CUDA graph is tested on the card by the
``cuda``-marked tests of ``test_torch_kernels_cuda.py`` (that file imports
no ``jax``, so it runs on a machine that has only the port).
"""

import re
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro import obs as ref_obs

from repro_torch import obs
from repro_torch.core.backends import torch_backend
from repro_torch.core.framework import estimate_union, warmup
from repro_torch.core.union_sampler import SamplerStats, SetUnionSampler
from repro_torch.data.workloads import uq1
from repro_torch.serve.service import SampleService


@pytest.fixture
def registry():
    """Fresh registry installed as the port's global one for the test."""
    reg = obs.MetricsRegistry()
    prev = obs.set_registry(reg)
    try:
        yield reg
    finally:
        obs.set_registry(prev)


@pytest.fixture
def obs_on():
    obs.set_enabled(True)
    try:
        yield
    finally:
        obs.set_enabled(None)


# ---------------------------------------------------------------------------
# metrics core
# ---------------------------------------------------------------------------


def test_registry_get_or_create_and_kind_conflicts(registry):
    c1 = registry.counter("t_total", "help one")
    c2 = registry.counter("t_total")
    assert c1 is c2
    with pytest.raises(ValueError):
        registry.gauge("t_total")           # same name, different kind
    with pytest.raises(ValueError):
        registry.counter("bad name!")       # invalid metric name
    with pytest.raises(ValueError):
        registry.counter("t_total", labelnames=("join",))   # other labels


def test_counter_labels_and_negative_rejection(registry):
    c = registry.counter("req_total", "requests", labelnames=("join",))
    c.labels("a").inc()
    c.labels("a").inc(2)
    c.labels(join="b").inc(5)
    snap = registry.snapshot()["req_total"]["series"]
    assert snap[(("join", "a"),)] == 3
    assert snap[(("join", "b"),)] == 5
    with pytest.raises(ValueError):
        c.labels("a").inc(-1)
    with pytest.raises(ValueError):
        c.inc()                             # labeled: needs .labels()


def test_gauge_set_function_pull_time(registry):
    g = registry.gauge("depth", "queue depth")
    box = {"v": 7}
    g.set_function(lambda: box["v"])
    assert registry.snapshot()["depth"]["series"][()] == 7
    box["v"] = 3
    assert registry.snapshot()["depth"]["series"][()] == 3


def test_histogram_quantiles_and_exposition(registry):
    h = registry.histogram("lat_seconds", "latency",
                           buckets=(0.001, 0.01, 0.1, 1.0))
    for v in [0.0005] * 50 + [0.05] * 50:
        h.observe(v)
    assert h.quantile(0.25) <= 0.001
    assert 0.01 <= h.quantile(0.99) <= 0.1
    text = registry.render()
    buckets = re.findall(r'lat_seconds_bucket{le="([^"]+)"} (\d+)', text)
    counts = [int(c) for _, c in buckets]
    assert counts == sorted(counts) and buckets[-1][0] == "+Inf"
    assert counts[-1] == 100
    assert re.search(r"^lat_seconds_count 100$", text, re.M)
    assert "# TYPE lat_seconds histogram" in text


def test_thread_safe_increments(registry):
    c = registry.counter("race_total")

    def work():
        for _ in range(10_000):
            c.inc()

    ts = [threading.Thread(target=work) for _ in range(8)]
    [t.start() for t in ts]
    [t.join() for t in ts]
    assert registry.snapshot()["race_total"]["series"][()] == 80_000


def test_kill_switch_env_and_override(monkeypatch):
    monkeypatch.setenv("REPRO_OBS", "off")
    obs.set_enabled(None)
    assert not obs.enabled()
    obs.set_enabled(True)
    assert obs.enabled()
    obs.set_enabled(None)
    monkeypatch.setenv("REPRO_OBS", "on")
    assert obs.enabled()
    monkeypatch.setenv("REPRO_OBS_TRACE", "1")
    assert obs.trace_annotations_enabled()


def _ops_counters(m):
    c = m.counter("repro_engine_rounds_total", "fused Algorithm-1 rounds run")
    c.inc(7)
    p = m.counter("repro_engine_piece_draws_total",
                  "candidate draws per cover piece", ("join",))
    p.labels(join="J0").inc(4096)
    p.labels(join='J"1\n').inc(3)       # escaped label values


def _ops_gauges(m):
    g = m.gauge("repro_round_waste_ratio",
                "1 - accepted/drawn per cover piece (cumulative)", ("join",))
    g.labels(join="J0").set(0.25)
    g.labels(join="J1").set(1.0 / 3.0)
    m.gauge("repro_serve_queue_depth", "prefetch queue occupancy").set(2)


def _ops_histograms(m):
    h = m.histogram("repro_serve_request_seconds",
                    "end-to-end SampleService.request latency")
    for v in (3e-5, 2e-3, 0.5, 120.0):
        h.observe(v)
    m.histogram("x_seconds", "custom", buckets=(0.1, 1.0)).observe(0.5)


@pytest.mark.parametrize("ops", [_ops_counters, _ops_gauges,
                                 _ops_histograms])
def test_exposition_text_equals_reference(ops):
    """One scraper reads both packages: the same operations on the port's
    and the reference's registries render the same text."""
    port, ref = obs.MetricsRegistry(), ref_obs.MetricsRegistry()
    ops(port)
    ops(ref)
    assert port.render() == ref.render()
    assert port.snapshot() == ref.snapshot()


# ---------------------------------------------------------------------------
# trace ring, HTTP endpoints, fallback record
# ---------------------------------------------------------------------------


def test_trace_ring_wrap_and_seq():
    ring = obs.TraceRing(capacity=4)
    for i in range(10):
        ring.append("tick", i=i)
    evs = ring.events()
    assert len(evs) == 4
    assert [e["i"] for e in evs] == [6, 7, 8, 9]
    assert [e["seq"] for e in evs] == [6, 7, 8, 9]
    assert ring.last()["i"] == 9
    assert ring.events("other") == []


def test_metrics_server_endpoints(registry):
    registry.counter("up_total", "ticks").inc(3)
    down = {"v": False}
    with obs.MetricsServer(registry, port=0,
                           health_fn=lambda: not down["v"]) as srv:
        with urllib.request.urlopen(f"{srv.url}/metrics") as r:
            body = r.read().decode()
            assert r.status == 200
            assert r.headers["Content-Type"] == obs.PROMETHEUS_CONTENT_TYPE
        assert "up_total 3" in body
        with urllib.request.urlopen(f"{srv.url}/healthz") as r:
            assert r.read().decode().strip() == "ok"
        down["v"] = True
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(f"{srv.url}/healthz")
        assert e.value.code == 503
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"{srv.url}/nope")


def test_record_fallback(registry, obs_on):
    n0 = len(obs.fallback_events())
    obs.record_fallback("host_oracle", detail="d", join="J0")
    snap = registry.snapshot()["repro_engine_fallback_total"]["series"]
    assert snap[(("reason", "host_oracle"),)] == 1
    ev = obs.fallback_events()[-1]
    assert len(obs.fallback_events()) == min(n0 + 1, 256)
    assert (ev["reason"], ev["join"]) == ("host_oracle", "J0")


def test_sampler_stats_merge_and_snapshot():
    a = SamplerStats(iterations=3, candidate_draws=10, cover_rejects=1)
    b = SamplerStats(iterations=2, candidate_draws=5, reuse_accepts=4)
    snap = a.snapshot()
    out = a.merge(b)
    assert out is a
    assert a.iterations == 5 and a.candidate_draws == 15
    assert a.cover_rejects == 1 and a.reuse_accepts == 4
    assert snap.iterations == 3
    c = SamplerStats(iterations=1)
    lhs = SamplerStats().merge(a).merge(c)
    rhs = SamplerStats().merge(c).merge(a)
    assert lhs.as_dict() == rhs.as_dict()


# ---------------------------------------------------------------------------
# engine: parity with telemetry on / off, piece_stats, engine series
# ---------------------------------------------------------------------------


def _workload(overlap=0.4, seed=0):
    wl = uq1(scale=0.02, overlap=overlap, seed=seed, n_joins=2)
    est = estimate_union(warmup(wl.cat, wl.joins, method="exact").oracle)
    return wl, est.cover


def _sampler(wl, cover, mode, seed=7, round_batch=512, **kw):
    return SetUnionSampler(wl.cat, wl.joins, cover, seed=seed, device="cpu",
                           round_batch=round_batch, fused_rounds=mode, **kw)


def _assert_same(a, b):
    for attr in a.attrs:
        np.testing.assert_array_equal(a.rows[attr], b.rows[attr])
    np.testing.assert_array_equal(a.home, b.home)
    np.testing.assert_array_equal(a.fingerprint, b.fingerprint)


def test_parity_unchanged_by_telemetry(registry):
    """Samples are bitwise identical device vs host, obs on vs off."""
    wl, cover = _workload()
    streams = {}
    for obs_state in (True, False):
        obs.set_enabled(obs_state)
        try:
            dev = _sampler(wl, cover, "device")
            host = _sampler(wl, cover, "host")
            for n in (700, 333):
                _assert_same(dev.sample(n), host.sample(n))
            assert dev.stats.as_dict() == host.stats.as_dict()
            assert np.array_equal(dev.engine.piece_stats,
                                  host.engine.piece_stats)
            streams[obs_state] = dev.sample(200)
        finally:
            obs.set_enabled(None)
    _assert_same(streams[True], streams[False])


@pytest.mark.parametrize("plan", ["static", "adaptive"])
def test_piece_stats_consistency(registry, obs_on, plan):
    """Per-piece draws tie out to candidate_draws, and the registry's
    engine series mirror the engine's own counters."""
    wl, cover = _workload()
    s = _sampler(wl, cover, "device", plan=plan)
    s.sample(800)
    s.sample(300)
    eng = s.engine
    fields = torch_backend.PIECE_STAT_FIELDS
    d = {name: {f: int(eng.piece_stats[j, i]) for i, f in enumerate(fields)}
         for j, name in enumerate(eng.order)}
    assert sum(v["draws"] for v in d.values()) == s.stats.candidate_draws
    assert all(v["draws"] > 0 for v in d.values())
    assert all(v["accepts"] <= v["draws"] for v in d.values())
    snap = registry.snapshot()
    for metric, field in (("repro_engine_piece_draws_total", "draws"),
                          ("repro_engine_piece_accepts_total", "accepts"),
                          ("repro_engine_piece_bank_drained_total",
                           "bank_drained"),
                          ("repro_engine_piece_bank_hwm", "bank_hwm")):
        series = snap[metric]["series"]
        for name, v in d.items():
            assert series[(("join", name),)] == v[field], metric
    waste = snap["repro_round_waste_ratio"]["series"]
    for name, v in d.items():
        assert waste[(("join", name),)] == pytest.approx(
            1.0 - v["accepts"] / v["draws"])
    assert snap["repro_engine_rounds_total"]["series"][()] == eng.total_rounds
    assert snap["repro_engine_samples_total"]["series"][()] == 1100
    assert snap["repro_engine_dispatch_seconds"]["series"][()]["count"] == 2
    assert snap["repro_engine_drain_seconds"]["series"][()]["count"] == 2
    ema = snap["repro_engine_piece_ema"]["series"]
    if plan == "adaptive":
        got = ema[(("join", eng.order[0]), ("component", "accept"))]
        assert got == eng._state.ema[0, 0].item() / 65536
    else:
        assert ema == {}


def test_engine_respects_kill_switch(registry):
    obs.set_enabled(False)
    try:
        wl, cover = _workload()
        s = _sampler(wl, cover, "device")
        assert len(s.sample(300)) == 300
        assert registry.snapshot() == {}
    finally:
        obs.set_enabled(None)


# ---------------------------------------------------------------------------
# serve: merged accounting under concurrent requesters + request metrics
# ---------------------------------------------------------------------------


def test_serve_concurrent_accounting_and_metrics(registry, obs_on):
    wl, cover = _workload(overlap=0.5, seed=1)
    s = _sampler(wl, cover, "device", seed=13, round_batch=1024)
    got, errs = [], []

    def worker(n):
        try:
            got.append(len(svc.request(n)))
        except Exception as e:          # pragma: no cover - diagnostic
            errs.append(e)

    with SampleService(s, batch=1024, prefetch=2) as svc:
        ts = [threading.Thread(target=worker, args=(n,))
              for n in (300, 700, 450, 1100)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        st = svc.stats()
        assert not errs and sorted(got) == [300, 450, 700, 1100]
        assert svc.served == 2550
        assert st.as_dict() == s.stats.as_dict()
    assert not registry._collectors          # removed on stop()
    snap = registry.snapshot()
    assert snap["repro_serve_requests_total"]["series"][()] == 4
    assert snap["repro_serve_samples_total"]["series"][()] == 2550
    lat = snap["repro_serve_request_seconds"]["series"][()]
    assert lat["count"] == 4 and lat["sum"] > 0
    assert snap["repro_serve_request_seconds_p50"]["series"][()] > 0
    assert snap["repro_serve_prefetch_capacity"]["series"][()] == 2
    eng = snap["repro_serve_engine_stat"]["series"]
    assert eng[(("replica", "0"), ("field", "candidate_draws"))] \
        == s.stats.candidate_draws
    assert eng[(("replica", "0"), ("field", "psi"))] == s.stats.psi()
    # the engine's samples series counts every row the producer made
    assert snap["repro_engine_samples_total"]["series"][()] \
        == s.stats.samples_emitted


def test_serve_respects_kill_switch(registry):
    obs.set_enabled(False)
    try:
        wl, cover = _workload(overlap=0.5, seed=1)
        s = _sampler(wl, cover, "device", seed=13, round_batch=1024)
        with SampleService(s, batch=1024, prefetch=1) as svc:
            assert len(svc.request(500)) == 500
        assert "repro_serve_requests_total" not in registry.snapshot()
    finally:
        obs.set_enabled(None)


# ---------------------------------------------------------------------------
# ONLINE-UNION refinement series
# ---------------------------------------------------------------------------


def test_online_exposes_refinement_series(registry, obs_on):
    from repro_torch.core.online import OnlineUnionSampler
    wl = uq1(scale=0.02, overlap=0.5, seed=0, n_joins=2)
    s = OnlineUnionSampler(wl.cat, wl.joins, seed=3, phi=5, device="cpu",
                           rw_batch=256)
    assert s.refresh_count == 0 and s.last_refresh_at == -1
    assert s.trace.last("init")["union_size"] > 0
    s.sample(600)
    assert s.refresh_count >= 1
    assert s.backtrack_count == s.stats.backtrack_removed
    snap = registry.snapshot()
    assert snap["repro_online_refreshes_total"]["series"][()] \
        == s.refresh_count
    assert snap["repro_online_union_size"]["series"][()] \
        == pytest.approx(s.cover.union_size)
    removed = snap.get("repro_online_backtrack_removed_total")
    assert (removed["series"][()] if removed else 0) == s.backtrack_count
