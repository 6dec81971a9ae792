"""The port's distributed façade against the reference's
(``repro.core.distributed``).

* ``partition_of``, ``merge_statistics`` and ``merge_streams`` equal the
  reference's on the same inputs, exactly.
* The two schemes of ``DistributedUnionSampler`` hold the reference's bars
  (``tests/test_sharding.py``): the merged stream of two replicas is
  uniform over the exact union under ``seed-split`` and
  ``hash-partition``, each hash-partition stream is partition-pure, an
  under-filled partition raises with its counts, and geometric growth
  fills a partition smaller than ``|U|/world``.
* The replicas serve through one ``SampleService``; ``mesh=`` forwards to
  the inner ``SetUnionSampler``.
"""

import numpy as np
import pytest
from scipy import stats as sps

from test_torch_support import to_port

from repro.core import distributed as ref_dist
from repro.core.framework import estimate_union as ref_estimate_union
from repro.core.framework import warmup as ref_warmup
from repro.core.overlap import exact_union_size
from repro.core.size_estimation import RunningMean as RefRunningMean
from repro.core.union_sampler import SampleSet as RefSampleSet
from repro.core.union_sampler import SamplerStats as RefStats
from repro.data.workloads import uq1, uq3

from repro_torch.core.distributed import (DistributedUnionSampler,
                                          merge_statistics, merge_streams,
                                          partition_of)
from repro_torch.core.sharding import ShardedUnionSampler, make_sampler_mesh
from repro_torch.core.size_estimation import RunningMean
from repro_torch.core.union_sampler import SampleSet, SamplerStats
from repro_torch.serve import SampleService


def _setup(name):
    """(workload, exact cover, exact union size) in the port's types."""
    wl = (uq1(scale=0.05, overlap=0.5, seed=1, n_joins=2) if name == "uq1"
          else uq3(scale=0.01, overlap=0.3, seed=0))
    est = ref_estimate_union(ref_warmup(wl.cat, wl.joins,
                                        method="exact").oracle)
    cat, specs, cover = to_port(wl.joins, est.cover)
    return cat, specs, cover, exact_union_size(wl.cat, wl.joins)


def _chi2_p(mat, U):
    uni, counts = np.unique(mat.view([("", mat.dtype)] * mat.shape[1]).ravel(),
                            return_counts=True)
    exp = mat.shape[0] / U
    chi2 = float(((counts - exp) ** 2 / exp).sum()) + (U - uni.shape[0]) * exp
    return 1 - sps.chi2.cdf(chi2, df=U - 1)


@pytest.mark.parametrize("world", [1, 2, 4, 64])
def test_partition_of_equals_reference(world):
    rng = np.random.default_rng(world)
    fp = rng.integers(0, 2**63, (5000, 2), dtype=np.int64).astype(np.uint64)
    fp[:8, 0] = [0, 1, 2**63, 2**64 - 1, 63, 64, 65, 2**32]
    got = partition_of(fp, world)
    assert got.dtype == np.int64
    assert np.array_equal(got, ref_dist.partition_of(fp, world))


def test_merge_statistics_equals_reference():
    rng = np.random.default_rng(0)
    xs = [rng.exponential(5.0, n) for n in (0, 64, 1, 300, 17)]
    port, ref = [], []
    for x in xs:
        a, b = RunningMean(), RefRunningMean()
        a.update_batch(x)
        b.update_batch(x)
        port.append(a)
        ref.append(b)
    got, want = merge_statistics(port), ref_dist.merge_statistics(ref)
    assert (got.count, got.mean, got.m2) == (want.count, want.mean, want.m2)
    # associative: any grouping gives the pooled moments of all the data
    pooled = RunningMean()
    pooled.update_batch(np.concatenate(xs))
    assert got.count == pooled.count
    assert got.mean == pytest.approx(pooled.mean, rel=1e-12)
    assert got.m2 == pytest.approx(pooled.m2, rel=1e-10)


def test_merge_streams_equals_reference():
    rng = np.random.default_rng(1)
    attrs = ["a", "b"]
    port, ref = [], []
    for k, n in enumerate((5, 0, 9)):
        rows = {a: rng.integers(0, 100, n) for a in attrs}
        home = rng.integers(0, 3, n)
        fp = rng.integers(0, 2**62, (n, 2)).astype(np.uint64)
        counts = dict(iterations=10 * k + 1, candidate_draws=k, revisions=n)
        port.append(SampleSet(attrs, rows, home, fp, SamplerStats(**counts)))
        ref.append(RefSampleSet(attrs, rows, home, fp, RefStats(**counts)))
    got, want = merge_streams(port, seed=4), ref_dist.merge_streams(ref,
                                                                    seed=4)
    assert np.array_equal(got.matrix(), want.matrix())
    assert np.array_equal(got.home, want.home)
    assert np.array_equal(got.fingerprint, want.fingerprint)
    # the port's stats hold every counter of the reference's, and the fused
    # engine's residual misses and member lookups (none here)
    stats = got.stats.as_dict()
    assert stats.pop("residual_misses") == 0
    assert stats.pop("member_lookups") == 0
    assert stats == want.stats.as_dict()
    assert got.stats.iterations == sum(10 * k + 1 for k in range(3))


@pytest.mark.parametrize("scheme", ["seed-split", "hash-partition"])
def test_schemes_uniform_over_the_union(scheme):
    cat, specs, cover, U = _setup("uq1")
    world = 2
    parts = []
    for rank in range(world):
        d = DistributedUnionSampler(cat, specs, cover, rank=rank, world=world,
                                    scheme=scheme, seed=5, device="cpu",
                                    round_batch=1024)
        parts.append(d.sample(40 * U))
        if scheme == "hash-partition":
            assert (partition_of(parts[-1].fingerprint, world) == rank).all()
    merged = merge_streams(parts, seed=2)
    assert len(merged) == 2 * 40 * U
    assert merged.stats.samples_emitted == sum(p.stats.samples_emitted
                                               for p in parts)
    p = _chi2_p(merged.matrix(), U)
    assert p > 1e-3, f"{scheme} union stream not uniform (p={p})"


def test_hash_partition_underfill_error_carries_counts():
    cat, specs, cover, _ = _setup("uq3")
    d = DistributedUnionSampler(cat, specs, cover, rank=0, world=64,
                                scheme="hash-partition", seed=3, device="cpu")
    with pytest.raises(RuntimeError, match=r"got \d+ of 4000"):
        d.sample(4000, oversample=0.01, max_rounds=1)


def test_hash_partition_geometric_growth_completes():
    cat, specs, cover, _ = _setup("uq1")
    d = DistributedUnionSampler(cat, specs, cover, rank=3, world=4,
                                scheme="hash-partition", seed=9, device="cpu")
    ss = d.sample(300, oversample=0.05, max_rounds=16)
    assert len(ss) == 300
    assert (partition_of(ss.fingerprint, 4) == 3).all()


def test_replicas_serve_and_forward_mesh():
    cat, specs, cover, _ = _setup("uq3")
    reps = [DistributedUnionSampler(cat, specs, cover, rank=r, world=2,
                                    seed=3, device="cpu", round_batch=512)
            for r in range(2)]
    with SampleService(reps, batch=512, prefetch=2) as svc:
        ss = [svc.request(700) for _ in range(3)]
    assert [len(s) for s in ss] == [700] * 3
    assert svc.served == 2100
    mm = reps[0].inner.prober.membership_matrix(ss[-1].rows, cover.order)
    assert np.array_equal(np.argmax(mm, axis=1), ss[-1].home)
    meshed = DistributedUnionSampler(cat, specs, cover, rank=1, world=2,
                                     seed=3, round_batch=512,
                                     mesh=make_sampler_mesh(device="cpu"))
    assert isinstance(meshed.inner.engine, ShardedUnionSampler)
    plain = DistributedUnionSampler(cat, specs, cover, rank=1, world=2,
                                    seed=3, device="cpu", round_batch=512)
    a, b = meshed.sample(900), plain.sample(900)
    assert np.array_equal(a.matrix(), b.matrix())
    assert np.array_equal(a.home, b.home)
    with pytest.raises(ValueError, match="seed-split requires"):
        DistributedUnionSampler(cat, specs, cover, rank=0, world=2,
                                membership="record", device="cpu")
    with pytest.raises(ValueError, match="unknown scheme"):
        DistributedUnionSampler(cat, specs, cover, rank=0, world=2,
                                scheme="round-robin", device="cpu")
