"""The port's device round loop (``fused_rounds="device"``) on the CPU.

On the card the round is one CUDA graph replayed ``K`` rounds at a time
between host syncs; on the CPU the same gated step runs eagerly in the same
chunks, so these tests cover the gating, the chunking and the rewind of the
uniforms that gated rounds drew:

* device mode equals host mode bit for bit (rows, homes, fingerprints,
  ``SamplerStats``, ``piece_stats``, the bank/shortfall carry and the
  position of the Philox stream) over calls that cross capacity classes,
  with the default chunk size and with a forced ``K`` far larger than a
  call needs (reference: ``tests/test_device_rounds.py``);
* under replayed uniforms, device mode equals the reference's
  ``fused_rounds="device"`` on UQ1 (dead pieces, dropped slots), UQ3, UQ4
  and under ``plan="adaptive"``, with forced chunk sizes;
* a tiny ring bank (head wrap, push clipping) agrees between the modes;
* ``max_rounds`` exhaustion raises the reference's error in both modes and
  leaves the same carry;
* ``balance="full"`` and ``balance_slack`` give the reference's widths;
* calls launched before the previous one is drained (``sample_async``),
  and the serve tier's producer over the device loop, give the samples,
  counters and carry of the same calls made one after the other, and count
  the drains that ran while a later call was in flight.
"""

import numpy as np
import pytest
import torch

from test_torch_support import (JaxReplay, sample_multiset, to_port,
                                union_setup)

from repro.core.backends import get_backend as ref_get_backend
from repro.core.backends.jax_backend import JaxUnionSampler
from repro.core.framework import estimate_union, warmup
from repro.core.union_sampler import SetUnionSampler as RefSetUnionSampler
from repro.data.workloads import uq1

from repro_torch.core.backends.torch_backend import (TorchBackend,
                                                     TorchUnionSampler)
from repro_torch import obs
from repro_torch.core.union_sampler import SetUnionSampler
from repro_torch.serve.service import SampleService

STAT_FIELDS = ("iterations", "candidate_draws", "cover_rejects",
               "residual_rejects", "pred_rejects", "dropped_slots",
               "samples_emitted")


def _small_uq1():
    """UQ1 with two joins at scale 0.02 over the exact cover (the
    reference's device/host parity workload)."""
    wl = uq1(scale=0.02, overlap=0.4, seed=0, n_joins=2)
    est = estimate_union(warmup(wl.cat, wl.joins, method="exact").oracle)
    return to_port(wl.joins, est.cover), wl, est


def _assert_same_samples(a, b):
    assert a.attrs == b.attrs
    for attr in a.attrs:
        np.testing.assert_array_equal(a.rows[attr], b.rows[attr])
    np.testing.assert_array_equal(a.home, b.home)
    np.testing.assert_array_equal(a.fingerprint, b.fingerprint)


def _assert_same_carry(x, y):
    """Both engines' carry between calls: banks, heads, counts, shortfall,
    dead flags, streaks (EMAs under the adaptive plan) and the stream."""
    for f in ("owed", "dead", "streak", "bank", "head", "count", "ema"):
        a, b = getattr(x._state, f), getattr(y._state, f)
        assert (a is None) == (b is None), f
        if f == "bank":                   # slot `cap` is the trash slot
            a, b = a[:, :-1], b[:, :-1]
        if a is not None:
            assert torch.equal(a, b), f
    assert torch.equal(x.uniforms.generator.get_state(),
                       y.uniforms.generator.get_state())


@pytest.mark.parametrize("chunk", [None, 16], ids=["auto-K", "forced-K16"])
def test_device_loop_matches_host_loop_bitwise(chunk):
    (cat, specs, cover), _, _ = _small_uq1()

    def make(mode):
        return SetUnionSampler(cat, specs, cover, seed=11, device="cpu",
                               round_batch=512, fused_rounds=mode)

    dev, host = make("device"), make("host")
    assert dev.engine.fused_rounds == "device"
    assert make(None).engine.fused_rounds == "device"      # the default
    dev.engine.chunk_rounds = chunk
    # successive odd-sized calls reuse banked surplus and carried shortfall;
    # 700 and 333 fall in the 1024 class, 1500 in the 2048 class
    for n in (700, 1500, 333):
        _assert_same_samples(dev.sample(n), host.sample(n))
        assert dev.stats.as_dict() == host.stats.as_dict()
        assert np.array_equal(dev.engine.piece_stats, host.engine.piece_stats)
        _assert_same_carry(dev.engine, host.engine)
        d, h = dev.engine, host.engine
        assert d.last_rounds == h.last_rounds == h.last_chunks
        assert h.last_host_syncs == h.last_rounds + 1
        assert d.last_host_syncs == d.last_chunks + 1
        if chunk is not None:
            # one chunk of 16 rounds, all but the call's rounds gated
            assert d.last_chunks == 1
            assert d.last_wasted_rounds == chunk - d.last_rounds > 0
    assert sorted(dev.engine._buffers) == [1024, 2048]
    assert dev.engine.total_rounds == host.engine.total_rounds


@pytest.mark.parametrize("name,plan,chunk", [
    ("uq1", "static", 3), ("uq3", "static", 2), ("uq4", "static", None),
    ("uq1", "adaptive", 5)])
def test_device_loop_equals_reference_under_replayed_uniforms(name, plan,
                                                              chunk):
    wl, est = union_setup(name)
    ref = RefSetUnionSampler(wl.cat, wl.joins, est.cover, seed=3,
                             backend="jax", round_batch=512,
                             fused_rounds="device", plan=plan)
    cat, specs, cover = to_port(wl.joins, est.cover)
    port = SetUnionSampler(cat, specs, cover, seed=3, device="cpu",
                           round_batch=512, uniforms=JaxReplay(3), plan=plan)
    eng = port.engine
    eng.chunk_rounds = chunk
    assert eng.fused_rounds == "device"
    assert eng.piece_batches == ref._engine.piece_batches
    wasted = 0
    # one capacity class (2048) on both sides: the reference compiles its
    # loop once per class (the class changes are the host-mode test's)
    for n in (1100, 2048, 1500):
        a, b = ref.sample(n), port.sample(n)
        assert np.array_equal(sample_multiset(a), sample_multiset(b))
        for f in STAT_FIELDS:
            assert getattr(a.stats, f) == getattr(b.stats, f), f
        assert np.array_equal(ref._engine.piece_stats, eng.piece_stats)
        assert ref._engine.last_rounds == eng.last_rounds
        st = ref._engine._dev_state
        for f, g in (("owed", "owed"), ("bank_count", "count"),
                     ("bank_head", "head"), ("dead", "dead")):
            assert np.array_equal(np.asarray(st[f]),
                                  getattr(eng._state, g).numpy()), f
        if plan == "adaptive":
            assert np.array_equal(np.asarray(st["ema"]),
                                  eng._state.ema.numpy())
        wasted += eng.last_wasted_rounds
    if chunk is not None:
        assert wasted > 0                 # the rewind ran
    if name == "uq1" and plan == "static":
        assert b.stats.dropped_slots > 0
    elif name != "uq1":
        assert b.stats.cover_rejects > 0


def test_fifo_bank_ring_wrap_equivalence():
    """A tiny ring capacity forces head wrap-around and push clipping; the
    device loop must replay the host loop's FIFO exactly."""
    (cat, specs, cover), _, _ = _small_uq1()
    backend = TorchBackend(cat, specs, device="cpu", seed=2)

    def engine(mode):
        return TorchUnionSampler(backend, cover, seed=7, round_batch=512,
                                 surplus_cap=64, fused_rounds=mode)

    dev, host = engine("device"), engine("host")
    for n in (333, 87, 512, 1025, 64):
        _assert_same_samples(dev.sample(n), host.sample(n))
        _assert_same_carry(dev, host)
    assert dev.stats.as_dict() == host.stats.as_dict()
    assert int(host.piece_stats[:, 4].max()) == 64      # the ring filled


def test_max_rounds_exhaustion_raises_the_reference_error():
    (cat, specs, cover), wl, est = _small_uq1()
    backend = TorchBackend(cat, specs, device="cpu", seed=2)
    engines = [TorchUnionSampler(backend, cover, seed=7, round_batch=256,
                                 max_rounds=2, fused_rounds=mode)
               for mode in ("device", "host")]
    ref = JaxUnionSampler(ref_get_backend("jax", wl.cat, wl.joins, seed=2),
                          est.cover, seed=7, round_batch=256, max_rounds=2)
    with pytest.raises(RuntimeError, match="top-up budget exhausted"):
        ref.sample(50_000)
    for e in engines:
        e.chunk_rounds = 8                # more than max_rounds allows
        with pytest.raises(RuntimeError, match="top-up budget exhausted"):
            e.sample(50_000)
        assert e.last_rounds == ref.last_rounds == 2
    dev, host = engines
    assert dev.last_wasted_rounds == 0    # K is capped at the rounds left
    _assert_same_carry(dev, host)
    # the next call continues from the same carry in both modes
    _assert_same_samples(dev.sample(300), host.sample(300))


@pytest.mark.parametrize("balance,slack", [("full", 1.5), ("cover", 1.5),
                                           ("cover", 3.0)])
def test_balance_widths_equal_reference(balance, slack):
    (cat, specs, cover), wl, est = _small_uq1()
    ref = JaxUnionSampler(ref_get_backend("jax", wl.cat, wl.joins),
                          est.cover, round_batch=2048, balance=balance,
                          balance_slack=slack)
    port = SetUnionSampler(cat, specs, cover, device="cpu", round_batch=2048,
                           balance=balance, balance_slack=slack)
    assert port.engine.piece_batches == ref.piece_batches
    if balance == "full":
        assert port.engine.piece_batches == (2048,) * len(specs)


def test_fused_rounds_validation_and_record_mode():
    (cat, specs, cover), _, _ = _small_uq1()
    with pytest.raises(ValueError, match="fused_rounds must be 'device' or "
                                         "'host', got 'gpu'"):
        SetUnionSampler(cat, specs, cover, device="cpu", fused_rounds="gpu")
    # record mode takes the flag and stays host-driven: one sync per round
    rec = SetUnionSampler(cat, specs, cover, device="cpu", round_batch=512,
                          membership="record", fused_rounds="device")
    assert len(rec.sample(400)) == 400
    assert rec.engine.last_host_syncs == rec.engine.last_rounds + 1


def _last_counts(eng):
    return (eng.last_rounds, eng.last_chunks, eng.last_host_syncs,
            eng.last_wasted_rounds)


@pytest.mark.parametrize("plan", ["static", "adaptive"])
@pytest.mark.parametrize("chunk", [None, 16], ids=["auto-K", "forced-K16"])
def test_pipelined_calls_equal_sequential_calls(chunk, plan):
    """Call k+1 launched before call k is drained, and a plain ``sample``
    while a call is in flight, give the rows, counters and carry of the
    same calls made one after the other; each drain leaves its own call's
    ``last_*`` counts on the engine."""
    (cat, specs, cover), _, _ = _small_uq1()

    def make():
        s = SetUnionSampler(cat, specs, cover, seed=11, device="cpu",
                            round_batch=512, plan=plan)
        s.engine.chunk_rounds = chunk
        return s

    pipe, seq = make(), make()
    pe, se = pipe.engine, seq.engine
    # 700, 333, 900 and 400 fall in the 1024 class, the others in 2048
    sizes = (700, 1500, 333, 2048, 900, 1200, 400)
    want, counts = [], []
    for n in sizes:
        want.append(seq.sample(n))
        counts.append(_last_counts(se))
    got = {}

    def drain(i, handle):
        got[i] = handle.result()
        assert _last_counts(pe) == counts[i], i
        assert pe.last_host_syncs == pe.last_chunks + 1

    h0 = pipe.sample_async(sizes[0])
    h1 = pipe.sample_async(sizes[1])    # finishes call 0, launches call 1
    drain(0, h0)                        # call 1 in flight: overlapped
    drain(1, h1)                        # finishes itself
    h2 = pipe.sample_async(sizes[2])
    got[3] = pipe.sample(sizes[3])      # finishes call 2 first
    assert _last_counts(pe) == counts[3]
    drain(2, h2)
    pending = pipe.sample_async(sizes[4])   # the serve tier's order
    for i in (5, 6):
        nxt = pipe.sample_async(sizes[i])
        drain(i - 1, pending)           # overlapped
        pending = nxt
    drain(6, pending)
    for i in range(len(sizes)):
        _assert_same_samples(got[i], want[i])
    assert pipe.stats.as_dict() == seq.stats.as_dict()
    assert np.array_equal(pe.piece_stats, se.piece_stats)
    _assert_same_carry(pe, se)
    for f in ("host_syncs", "total_rounds", "wasted_rounds"):
        assert getattr(pe, f) == getattr(se, f), f
    assert (pe.overlapped_drains, se.overlapped_drains) == (3, 0)
    if chunk is not None:
        assert pe.wasted_rounds > 0       # the rewind ran between calls


def test_service_drains_while_the_next_call_runs():
    """``SampleService`` over the device loop drains call k while call
    k+1 is launched, counts those drains in the engine and the registry,
    and serves the rows of the same seed's sequential calls."""
    (cat, specs, cover), _, _ = _small_uq1()

    def make():
        return SetUnionSampler(cat, specs, cover, seed=5, device="cpu",
                               round_batch=512)

    served, seq = make(), make()
    reg = obs.MetricsRegistry()
    prev = obs.set_registry(reg)
    obs.set_enabled(True)
    try:
        with SampleService(served, batch=2048, prefetch=2) as svc:
            got = [svc.request(n) for n in (1500, 1000, 1596)]
            producer = svc._threads[0]
    finally:
        obs.set_enabled(None)
        obs.set_registry(prev)
    assert not producer.is_alive()        # stop() joined it
    eng = served.engine
    assert eng.overlapped_drains > 0
    snap = reg.snapshot()["repro_engine_overlapped_drains_total"]["series"]
    assert snap[()] == eng.overlapped_drains
    want = [seq.sample(2048) for _ in range(2)]
    for a in seq.attrs:
        np.testing.assert_array_equal(
            np.concatenate([g.rows[a] for g in got]),
            np.concatenate([w.rows[a] for w in want]))
    for f in ("home", "fingerprint"):
        np.testing.assert_array_equal(
            np.concatenate([getattr(g, f) for g in got]),
            np.concatenate([getattr(w, f) for w in want]))
