"""The sharded engine's per-rank device loop (``fused_rounds="device"``
with ``mesh=``) on the CPU.

* At world 1 (no process group, no collective) the device loop equals the
  sharded host loop and the unsharded device loop bit for bit: rows,
  homes, fingerprints, ``SamplerStats``, ``piece_stats`` and the carry,
  over the calls (900, 411) of the reference's own parity test
  (``tests/test_device_rounds.py``), with the default and a forced chunk
  size, under ``plan="static"`` and ``"adaptive"`` and on the cyclic UQ4.
* At world 1, under replayed JAX uniforms, it equals the reference's
  1-device mesh in ``fused_rounds="device"`` (its ``shard_map``'d
  ``while_loop``): rows, stats, rounds and the per-shard bank carry.
* ``SetUnionSampler(mesh=)`` and ``ShardedUnionSampler`` default to the
  device loop, as the reference's do; ``fused_rounds="host"`` stays.
* Gloo worlds 2 and 4 (``test_torch_mesh_support.check_device_loop``) run
  inside the spawns of ``tests/test_torch_sharding.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_support import JaxReplay, sample_multiset, to_port

from repro.core.framework import estimate_union, warmup
from repro.core.sharding import make_sampler_mesh as ref_make_mesh
from repro.core.union_sampler import SetUnionSampler as RefSetUnionSampler
from repro.data.workloads import uq1, uq4

from repro_torch.core.sharding import (ShardedCatalog, ShardedUnionSampler,
                                       make_sampler_mesh)
from repro_torch.core.union_sampler import SetUnionSampler
from repro_torch.launch.serve import main as serve_main

STAT_FIELDS = ("iterations", "candidate_draws", "cover_rejects",
               "residual_rejects", "pred_rejects", "dropped_slots",
               "samples_emitted")


def _mesh1():
    return make_sampler_mesh(world=1, device="cpu")


def _setup(name):
    if name == "uq4":
        wl = uq4(scale=0.05, seed=0)
        order = ["UQ4_CHAIN", "UQ4_CYC"]
    else:
        wl = uq1(scale=0.02, overlap=0.4, seed=0, n_joins=2)
        order = None
    est = estimate_union(warmup(wl.cat, wl.joins, method="exact").oracle,
                         order=order)
    return wl, est


def _same(a, b):
    assert np.array_equal(a.matrix(), b.matrix())
    assert np.array_equal(a.home, b.home)
    assert np.array_equal(a.fingerprint, b.fingerprint)


@pytest.mark.parametrize("name,plan,chunk", [
    ("uq1", "static", None), ("uq1", "static", 16),
    ("uq1", "adaptive", None), ("uq4", "static", 3)])
def test_world1_device_equals_host_mesh_and_unsharded(name, plan, chunk):
    wl, est = _setup(name)
    cat, specs, cover = to_port(wl.joins, est.cover)

    def engine(mode, mesh):
        return SetUnionSampler(cat, specs, cover, seed=9, round_batch=512,
                               mesh=mesh, fused_rounds=mode, plan=plan,
                               device=None if mesh else "cpu")

    in_loop = engine(None, _mesh1())          # the default: device
    between = engine("host", _mesh1())
    plain = engine("device", None)
    dev = in_loop.engine
    assert dev.fused_rounds == "device" and between.engine.fused_rounds == \
        "host"
    dev.chunk_rounds = chunk
    for n in (900, 411):
        a, b, c = in_loop.sample(n), between.sample(n), plain.sample(n)
        _same(a, b)
        _same(a, c)
        assert in_loop.stats.as_dict() == between.stats.as_dict()
        assert in_loop.stats.as_dict() == plain.stats.as_dict()
        assert np.array_equal(dev.piece_stats, plain.engine.piece_stats)
        assert dev.last_rounds == plain.engine.last_rounds
        assert dev.last_host_syncs == dev.last_chunks + 1
        for f in ("owed", "dead", "streak", "bank", "head", "count", "ema"):
            x, y = getattr(dev._state, f), getattr(plain.engine._state, f)
            assert (x is None) == (y is None), f
            if f == "bank":               # slot `cap` is the trash slot
                x, y = x[:, :-1], y[:, :-1]
            if x is not None:
                assert torch.equal(x, y), f
        if plan == "adaptive":
            assert torch.equal(dev._state.gcount, dev._state.count)
        assert torch.equal(dev.uniforms.generator.get_state(),
                           plain.engine.uniforms.generator.get_state())
    if chunk is not None:
        assert dev.wasted_rounds > 0                # the rewind ran
    assert int(dev.piece_stats[:, 3].sum()) > 0     # the banks drained


@pytest.mark.parametrize("plan", ["static", "adaptive"])
def test_world1_device_equals_reference_mesh_device_loop(plan):
    wl, est = _setup("uq1")
    ref = RefSetUnionSampler(wl.cat, wl.joins, est.cover, seed=3,
                             backend="jax", round_batch=512,
                             mesh=ref_make_mesh(world=1),
                             fused_rounds="device", plan=plan)
    cat, specs, cover = to_port(wl.joins, est.cover)
    port = SetUnionSampler(cat, specs, cover, seed=3, round_batch=512,
                           uniforms=JaxReplay(3), mesh=_mesh1(), plan=plan)
    eng = port.engine
    eng.chunk_rounds = 4
    assert eng.fused_rounds == "device"
    assert eng.piece_batches == ref._engine.piece_batches
    # one capacity class (1024) on both sides: the reference compiles its
    # loop once per class
    for n in (900, 411, 1000):
        a, b = ref.sample(n), port.sample(n)
        assert np.array_equal(sample_multiset(a), sample_multiset(b))
        for f in STAT_FIELDS:
            assert getattr(a.stats, f) == getattr(b.stats, f), f
        assert np.array_equal(ref._engine.piece_stats, eng.piece_stats)
        assert ref._engine.last_rounds == eng.last_rounds
        st = ref._engine._dev_state
        for f, g in (("owed", "owed"), ("dead", "dead"),
                     ("streak", "streak")):
            assert np.array_equal(np.asarray(st[f]),
                                  getattr(eng._state, g).numpy()), f
        # the reference's banks are (world, nj, ...) per shard
        for f, g in (("bank_count", "count"), ("bank_head", "head")):
            assert np.array_equal(np.asarray(st[f])[0],
                                  getattr(eng._state, g).numpy()), f
        if plan == "adaptive":
            assert np.array_equal(np.asarray(st["ema"]),
                                  eng._state.ema.numpy())
            assert np.array_equal(np.asarray(st["gcount"]),
                                  eng._state.gcount.numpy())
    assert b.stats.cover_rejects > 0 and eng.wasted_rounds > 0


def test_sharded_engine_defaults_to_the_device_loop():
    wl, est = _setup("uq1")
    cat, specs, cover = to_port(wl.joins, est.cover)
    scat = ShardedCatalog(cat, specs, mesh=_mesh1())
    assert ShardedUnionSampler(scat, cover).fused_rounds == "device"
    assert ShardedUnionSampler(scat, cover,
                               fused_rounds="host").fused_rounds == "host"
    s = SetUnionSampler(cat, specs, cover, mesh=_mesh1(), round_batch=512)
    assert s.engine.fused_rounds == "device"
    assert s.engine._bank_cap() == s.engine.surplus_cap
    out = serve_main(["--mode", "samples", "--device", "cpu", "--scale",
                      "0.05", "--requests", "2", "--samples", "256",
                      "--round-batch", "1024", "--shards", "1"])
    assert out["fused_rounds"] == "device" and out["samples"] == 512
