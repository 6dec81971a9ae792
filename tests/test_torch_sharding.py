"""The port's sharded execution layer against the reference's
(``repro.core.sharding``).

* The partition arithmetic — ``row_range_bounds``, ``partition_of_fp32``
  and each rank's owned fingerprint index (``owned_fingerprints``) —
  equals the reference's numpy arithmetic (``catalog.py:74-92``,
  ``:178-214``) at worlds 1, 2, 4 and 64, on every rank.
* A world of one (no process group, no collective) degenerates to the
  unsharded engine: the catalog's per-rank state equals the unsharded
  tensors, and ``SetUnionSampler(mesh=)`` equals the unsharded port bit for
  bit (rows, homes, fingerprints, ``SamplerStats``, per-piece counters)
  under ``plan="static"``, under ``"adaptive"``, with §8.3 rejection
  predicates and on the cyclic UQ4; under replayed uniforms it equals the
  reference's 1-device mesh.  The estimator's mesh path at world 1 equals
  the warm-up without a mesh, and the reference's 1-device mesh warm-up.
* In 2 and 4 gloo processes on the CPU (``test_torch_mesh_support``): the
  fingerprint exchange equals unsharded membership exactly, the moment
  merge over the ranks equals ``merge_statistics``, and at world 4 UQ1
  (static and adaptive plan) and UQ4 pass the reference's chi-square and
  marginal bars and the online sampler's mesh smoke holds.
* The guards: record membership and ``world > 1`` without a process group
  raise, and so do ``mesh=`` with the exact warm-up or a foreign estimator.
"""

import numpy as np
import pytest
import torch

from test_torch_mesh_support import spawn
from test_torch_support import (JaxReplay, JaxWalkReplay, sample_multiset,
                                to_port)

from repro.core.backends.jax_backend import fp32_np
from repro.core.framework import estimate_union as ref_estimate_union
from repro.core.framework import warmup as ref_warmup
from repro.core.sharding import make_sampler_mesh as ref_make_mesh
from repro.core.sharding import partition_of_fp32 as ref_partition_of_fp32
from repro.core.sharding import row_range_bounds as ref_row_range_bounds
from repro.core.union_sampler import SetUnionSampler as RefSetUnionSampler
from repro.data.workloads import uq1, uq2, uq3, uq4

from repro_torch.core.backends.torch_backend import TorchJoinMembership, fp32
from repro_torch.core.framework import estimate_union, warmup
from repro_torch.core.online import OnlineUnionSampler
from repro_torch.core.sharding import (ShardedCatalog, ShardedUnionSampler,
                                       make_sampler_mesh, owned_fingerprints,
                                       partition_of_fp32, rank_stream_seed,
                                       row_range_bounds)
from repro_torch.core.union_sampler import SetUnionSampler
from repro_torch.launch.serve import main as serve_main

STAT_FIELDS = ("iterations", "candidate_draws", "cover_rejects",
               "residual_rejects", "pred_rejects", "dropped_slots",
               "samples_emitted")


def _mesh1():
    return make_sampler_mesh(world=1, device="cpu")


@pytest.mark.parametrize("world", [1, 2, 4, 64])
def test_partition_arithmetic_equals_reference(world):
    for nrows in (0, 1, 103, 4096):
        assert np.array_equal(row_range_bounds(nrows, world),
                              ref_row_range_bounds(nrows, world))
    wl = uq3(scale=0.01)
    for rel in {n.relation.name: n.relation for j in wl.joins
                for n in j.nodes}.values():
        attrs = tuple(sorted(rel.attrs))
        fp1 = fp32_np([rel.columns[a] for a in attrs], salt=1)
        fp2 = fp32_np([rel.columns[a] for a in attrs], salt=2)
        owner = ref_partition_of_fp32(fp1, world)
        assert np.array_equal(partition_of_fp32(fp1, world), owner)
        cols = [torch.as_tensor(rel.columns[a].astype(np.int32))
                for a in attrs]
        t1, t2 = fp32(cols, salt=1), fp32(cols, salt=2)
        assert np.array_equal(t1.numpy(), fp1.astype(np.int64))
        kmax_ref = 0
        kmax_port = 0
        for s in range(world):
            # the reference's per-shard build (catalog.py:186-200)
            idx = np.nonzero(owner == s)[0]
            order = idx[np.argsort(fp1[idx], kind="stable")]
            s1 = fp1[order]
            if s1.shape[0]:
                kmax_ref = max(kmax_ref, int(np.unique(
                    s1, return_counts=True)[1].max()))
            g1, g2, n, kmax = owned_fingerprints(t1, t2, world, s)
            kmax_port = max(kmax_port, kmax)
            assert n == s1.shape[0]
            assert np.array_equal(g1[:n].numpy(), s1.astype(np.int64))
            assert np.array_equal(g2[:n].numpy(),
                                  fp2[order].astype(np.int64))
            assert g1.shape[0] == max(n, 1)
        assert kmax_port == kmax_ref


def test_rank_streams_are_distinct():
    seeds = {rank_stream_seed(s, r, k) for s in range(4) for r in range(4)
             for k in (1, 2)}
    assert len(seeds) == 32
    assert seeds.isdisjoint(range(1 << 16))
    assert all(0 <= x < (1 << 63) for x in seeds)


def test_sharded_catalog_world1_degenerates_to_the_engine():
    wl = uq3(scale=0.01, overlap=0.3, seed=0)
    scat = ShardedCatalog(wl.cat, wl.joins, mesh=_mesh1())
    for j in wl.joins:
        st = scat.trees[j.name]
        assert st.mode == "replicated"
        assert st.store_bounds[0] == 0 and st.store_bounds[-1] == st.n_root
        assert torch.equal(st.root_prefix, st.tree.root_wprefix)
        dm = TorchJoinMembership(j, device="cpu")
        sm = scat.members[j.name]
        assert len(sm.rels) == len(dm.rels)
        for r_s, (attrs, s1, s2, kmax, nrows) in zip(sm.rels, dm.rels):
            assert (r_s.attrs, r_s.kmax, r_s.n_owned) == (attrs, kmax, nrows)
            assert torch.equal(r_s.fp1, s1) and torch.equal(r_s.fp2, s2)
    rel = wl.joins[0].nodes[0].relation
    shards = scat.columns_for(rel)
    assert scat.columns_for(rel) is shards          # cached
    for a, c in rel.columns.items():
        assert np.array_equal(shards[a].numpy(), c)


def _case(name):
    """(workload, exact estimates, SetUnionSampler kwargs)."""
    if name == "uq2_rejection":
        wl = uq2(scale=0.02, seed=0, pred_mode="rejection")
        assert all(j.reject_preds for j in wl.joins)
    elif name == "uq4":
        wl = uq4(scale=0.05, seed=0)
    else:
        wl = uq1(scale=0.05, overlap=0.5, seed=1, n_joins=3)
    order = ["UQ4_CHAIN", "UQ4_CYC"] if name == "uq4" else None
    est = ref_estimate_union(ref_warmup(wl.cat, wl.joins,
                                        method="exact").oracle, order=order)
    return wl, est, dict(plan="adaptive" if name == "adaptive" else "static")


@pytest.mark.parametrize("name", ["static", "adaptive", "uq2_rejection",
                                  "uq4"])
def test_world1_mesh_equals_unsharded_and_reference(name):
    wl, est, kw = _case(name)
    cat, specs, cover = to_port(wl.joins, est.cover)
    plain = SetUnionSampler(cat, specs, cover, seed=7, device="cpu",
                            round_batch=512, **kw)
    meshed = SetUnionSampler(cat, specs, cover, seed=7, round_batch=512,
                             mesh=_mesh1(), **kw)
    eng = meshed.engine
    assert isinstance(eng, ShardedUnionSampler) and eng.world == 1
    assert eng.piece_batches == plain.engine.piece_batches
    assert eng.shard_piece_batches == eng.piece_batches
    for n in (1100, 2048):
        a, b = plain.sample(n), meshed.sample(n)
        assert np.array_equal(a.matrix(), b.matrix())
        assert np.array_equal(a.home, b.home)
        assert np.array_equal(a.fingerprint, b.fingerprint)
        assert a.stats.as_dict() == b.stats.as_dict()
        assert np.array_equal(plain.engine.piece_stats, eng.piece_stats)
    if name == "uq2_rejection":
        assert b.stats.pred_rejects > 0
    # under replayed uniforms: the reference's 1-device mesh, driven by its
    # host loop (the port's loop; at world 1 bit-equal to its device loop)
    ref = RefSetUnionSampler(wl.cat, wl.joins, est.cover, seed=3,
                             backend="jax", round_batch=512,
                             mesh=ref_make_mesh(world=1),
                             fused_rounds="host", **kw)
    port = SetUnionSampler(cat, specs, cover, seed=3, round_batch=512,
                           uniforms=JaxReplay(3), mesh=_mesh1(), **kw)
    for n in (1100, 1500):
        a, b = ref.sample(n), port.sample(n)
        assert np.array_equal(sample_multiset(a), sample_multiset(b))
        for f in STAT_FIELDS:
            assert getattr(a.stats, f) == getattr(b.stats, f), f
        assert ref._engine.last_rounds == port.engine.last_rounds
    assert b.stats.cover_rejects > 0


def test_world1_estimator_mesh_equals_plain_and_reference():
    wl = uq1(scale=0.05, overlap=0.4, seed=0, n_joins=2)
    cat, specs, _ = to_port(wl.joins)
    kw = dict(method="random_walk", seed=2, rw_batch=256, rw_max_walks=2048)
    plain = warmup(cat, specs, device="cpu", **kw)
    meshed = warmup(cat, specs, mesh=_mesh1(), **kw)
    ref = ref_warmup(wl.cat, wl.joins, backend="jax",
                     mesh=ref_make_mesh(world=1), **kw)
    replay = warmup(cat, specs, mesh=_mesh1(), uniforms=JaxWalkReplay(2),
                    **kw)
    a, b = ref_estimate_union(ref.oracle), estimate_union(replay.oracle)
    assert b.union_size_cover == pytest.approx(a.union_size_cover, rel=1e-5)
    for j, pj in zip(wl.joins, specs):
        assert meshed.oracle.size(pj.name) == plain.oracle.size(pj.name)
        assert replay.oracle.size(pj.name) == pytest.approx(
            ref.oracle.size(j.name), rel=1e-5)
    for k in ref.aux.overlap_stats:
        assert replay.aux.overlap_stats[k].count == \
            ref.aux.overlap_stats[k].count
    estimate_union(plain.oracle), estimate_union(meshed.oracle)
    assert plain.aux.overlap_stats.keys() == meshed.aux.overlap_stats.keys()
    for k, st in plain.aux.overlap_stats.items():
        m = meshed.aux.overlap_stats[k]
        assert (m.count, m.mean, m.half_width()) == \
            (st.count, st.mean, st.half_width())
    for k, st in plain.aux.size_stats.items():
        assert meshed.aux.size_stats[k].count == st.count > 0


def test_mesh_guards():
    wl = uq3(scale=0.01)
    est = ref_estimate_union(ref_warmup(wl.cat, wl.joins,
                                        method="exact").oracle)
    cat, specs, cover = to_port(wl.joins, est.cover)
    with pytest.raises(ValueError, match="membership='record'"):
        SetUnionSampler(cat, specs, cover, membership="record", mesh=_mesh1())
    with pytest.raises(ValueError, match="differs from the mesh"):
        SetUnionSampler(cat, specs, cover, device="cuda", mesh=_mesh1())
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        make_sampler_mesh(world=2, device="cpu")
    with pytest.raises(ValueError, match="random_walk' only"):
        warmup(cat, specs, method="exact", mesh=_mesh1())
    with pytest.raises(ValueError, match="device estimator"):
        OnlineUnionSampler(cat, specs, estimator="numpy", mesh=_mesh1())


def test_mesh_needs_a_group_when_a_launcher_says_so(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="WORLD_SIZE is set"):
        make_sampler_mesh(device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert make_sampler_mesh(device="cpu").world == 1


def test_serve_cli_shards():
    out = serve_main(["--mode", "samples", "--device", "cpu", "--scale",
                      "0.05", "--requests", "2", "--samples", "256",
                      "--round-batch", "1024", "--shards", "1"])
    assert out["samples"] == 512 and out["shards"] == 1
    with pytest.raises(RuntimeError, match="process group of 2 ranks"):
        serve_main(["--mode", "samples", "--device", "cpu", "--scale",
                    "0.05", "--shards", "2"])


def test_two_gloo_ranks_exchange_and_merge():
    spawn("world2", 2)


def test_four_gloo_ranks_exchange_merge_uniform_online():
    spawn("world4", 4)
