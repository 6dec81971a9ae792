"""The paper's baselines and the chain façade of the port against the
reference's.

* With every candidate source's rounds replayed from the reference's JAX
  keys (``JaxSourcesReplay``: join ``i`` from ``seed + i``) and the same
  host seed, ``DisjointUnionSampler`` and ``BernoulliUnionSampler`` equal
  the reference's ``backend="jax"`` samplers over two ``sample(n)`` calls:
  rows, ``home``, fingerprints and every ``SamplerStats`` counter, on UQ3 at
  scale 0.01 and on the cyclic UQ4.
* ``TorchChainSampler`` under the same replay equals ``JaxChainSampler``
  (batches and ``sample_uniform``), and keeps its chain-only validation.
* With its own Philox streams each baseline meets the reference's bar
  (``tests/test_union.py``): Bernoulli uniform over the exact union
  (chi-square at 80·U), Disjoint's home shares within 0.03 of
  ``|J_j|/Σ|J|``.
* The reference's errors: degenerate join sizes, round budget exhausted.
"""

import numpy as np
import pytest
from scipy import stats as sps

from conftest import tiny_db
from test_torch_support import JaxSourceReplay, JaxSourcesReplay, to_port

from repro.core.framework import warmup
from repro.core.index import Catalog as RefCatalog
from repro.core.jax_sampler import JaxChainSampler
from repro.core.joins import chain_join
from repro.core.overlap import exact_union_size
from repro.core.union_sampler import (
    BernoulliUnionSampler as RefBernoulli,
    DisjointUnionSampler as RefDisjoint)
from repro.data.workloads import uq1, uq3, uq4

from repro_torch.core.torch_sampler import TorchChainSampler
from repro_torch.core.union_sampler import (BernoulliUnionSampler,
                                            DisjointUnionSampler)

STAT_FIELDS = ("iterations", "candidate_draws", "cover_rejects",
               "residual_rejects", "pred_rejects", "canonical_rejects",
               "revisions", "dropped_slots", "reuse_accepts", "reuse_rejects",
               "backtrack_removed", "samples_emitted")


def _workload(name):
    """(workload, exact join sizes, exact union size)."""
    wl = uq3(scale=0.01) if name == "uq3" else uq4(scale=0.05, seed=0)
    wr = warmup(wl.cat, wl.joins, method="exact")
    sizes = {j.name: wr.oracle.size(j.name) for j in wl.joins}
    return wl, sizes, float(exact_union_size(wl.cat, wl.joins))


def _assert_same(a, b):
    assert np.array_equal(a.matrix(), b.matrix())
    assert np.array_equal(a.home, b.home)
    assert np.array_equal(a.fingerprint, b.fingerprint)
    for f in STAT_FIELDS:
        assert getattr(a.stats, f) == getattr(b.stats, f), f


@pytest.mark.parametrize("name", ["uq3", "uq4"])
def test_disjoint_equals_reference_under_replay(name):
    wl, sizes, _ = _workload(name)
    ref = RefDisjoint(wl.cat, wl.joins, sizes, seed=3, backend="jax")
    cat, specs, _ = to_port(wl.joins)
    port = DisjointUnionSampler(cat, specs, sizes, seed=3, device="cpu",
                                uniforms=JaxSourcesReplay(3))
    for n in (700, 5000):          # the second call refills mid-request
        a, b = ref.sample(n), port.sample(n)
        assert len(b) == n and b.rows[port.attrs[0]].dtype == np.int64
        _assert_same(a, b)
    assert set(np.unique(b.home)) == set(range(len(specs)))


@pytest.mark.parametrize("name", ["uq3", "uq4"])
def test_bernoulli_equals_reference_under_replay(name):
    wl, sizes, U = _workload(name)
    ref = RefBernoulli(wl.cat, wl.joins, sizes, U, seed=5, backend="jax")
    cat, specs, _ = to_port(wl.joins)
    port = BernoulliUnionSampler(cat, specs, sizes, U, seed=5, device="cpu",
                                 uniforms=JaxSourcesReplay(5))
    for n in (300, 1200):
        a, b = ref.sample(n), port.sample(n)
        assert len(b) == n
        _assert_same(a, b)
    assert b.stats.canonical_rejects > 0
    # every row lies in its home join and in no earlier join
    mm = port.prober.membership_matrix(b.rows, [j.name for j in specs])
    assert np.array_equal(np.argmax(mm, axis=1), b.home)


def test_baselines_philox_meet_the_reference_bar():
    wl, sizes, U = _workload("uq3")
    cat, specs, _ = to_port(wl.joins)
    bern = BernoulliUnionSampler(cat, specs, sizes, U, seed=9, device="cpu")
    ss = bern.sample(int(80 * U))
    m = ss.matrix()
    uni, counts = np.unique(m.view([("", m.dtype)] * m.shape[1]).ravel(),
                            return_counts=True)
    N, exp = m.shape[0], m.shape[0] / U
    chi2 = float(((counts - exp) ** 2 / exp).sum()) + (U - uni.shape[0]) * exp
    p = 1 - sps.chi2.cdf(chi2, df=U - 1)
    assert p > 1e-3, f"Bernoulli union sampler not uniform: p={p}"
    assert ss.stats.canonical_rejects > 0 and N == int(80 * U)
    disj = DisjointUnionSampler(cat, specs, sizes, seed=10, device="cpu")
    ss = disj.sample(6000)
    tot = sum(sizes.values())
    for j_idx, j in enumerate(specs):
        frac = (ss.home == j_idx).mean()
        assert frac == pytest.approx(sizes[j.name] / tot, abs=0.03)


def test_baselines_keep_the_reference_errors():
    wl, sizes, U = _workload("uq3")
    cat, specs, _ = to_port(wl.joins)
    with pytest.raises(ValueError, match="degenerate join sizes"):
        DisjointUnionSampler(cat, specs, {j.name: 0.0 for j in specs},
                             device="cpu")
    with pytest.raises(ValueError, match="unknown backend 'jax'"):
        DisjointUnionSampler(cat, specs, sizes, backend="jax", device="cpu")
    bern = BernoulliUnionSampler(cat, specs, sizes, U, seed=1, device="cpu")
    with pytest.raises(RuntimeError, match="round budget exhausted"):
        bern.sample(10_000, round_size=16, max_rounds=2)


def _chains():
    """UQ1's first join (a five-way chain) and the tiny R ⋈ S ⋈ T chain."""
    R, S, T = tiny_db(1)
    return [uq1(scale=0.05, overlap=0.5, seed=1).joins[0],
            chain_join("RSTj1", [R, S, T], ["b", "c"])]


@pytest.mark.parametrize("which", [0, 1])
def test_chain_sampler_equals_reference_under_replay(which):
    spec = _chains()[which]
    ref = JaxChainSampler(RefCatalog(), spec, seed=4)
    cat, specs, _ = to_port([spec])
    port = TorchChainSampler(cat, specs[0], device="cpu",
                             uniforms=JaxSourceReplay(4))
    assert port.n_hops == ref.n_hops and port.attrs == ref.attrs
    for batch in (512, 300):
        (ra, oa), (rb, ob) = ref.sample_batch(batch), port.sample_batch(batch)
        assert np.array_equal(oa, ob) and ob.any()
        for a in port.attrs:
            assert rb[a].dtype == np.int64
            assert np.array_equal(ra[a][oa], rb[a][ob]), a
    a, b = ref.sample_uniform(1500, batch=256), port.sample_uniform(
        1500, batch=256)
    for attr in port.attrs:
        assert np.array_equal(a[attr], b[attr]), attr


def test_chain_sampler_keeps_the_chain_only_validation():
    cat3, specs3, _ = to_port(uq3(scale=0.01).joins)
    cat4, specs4, _ = to_port(uq4(scale=0.05, seed=0).joins)
    branching = next(j for j in specs3 if not j.is_chain)
    cyclic = next(j for j in specs4 if j.is_cyclic)
    with pytest.raises(ValueError, match="non-chain acyclic"):
        TorchChainSampler(cat3, branching, device="cpu")
    with pytest.raises(ValueError, match="is cyclic"):
        TorchChainSampler(cat4, cyclic, device="cpu")
