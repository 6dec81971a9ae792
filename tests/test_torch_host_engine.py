"""The port's host engine (``backend="numpy"``) and the reference's six
degrade paths.

* With a shared numpy seed the port's host draws equal the reference's
  exactly: ``JoinSampler.sample_batch`` / ``sample_uniform`` /
  ``acceptance_rate`` for ``ew``, ``eo`` and ``wj`` on a chain, UQ3's
  branching join and a cyclic join whose residual has ``M > 1``;
  ``NumpyBackend``'s sources and its ``MembershipProber``;
  ``NumpyEstimator``'s walks.
* ``SetUnionSampler(backend="numpy")`` equals the reference's rows, homes,
  fingerprints and ``SamplerStats`` in probe mode (EW and EO), with §8.3
  rejection predicates, in record mode and under ``strict_paper_loop``
  (patterns of ``tests/test_sampling.py`` and ``tests/test_union.py``), and
  the Disjoint and Bernoulli baselines do on the numpy backend.
* Each of the six degrade cases records the reference's
  ``record_fallback`` reason (both packages run the same case), and runs:
  ``strict_paper_loop`` on the device backend, a predicate that does not
  lower, ``join_method="eo"`` on the device backend (records, then raises),
  the mixed union with one join at ``1 << 31`` (that join draws on the
  host, fused rounds turn off, membership goes to the host oracle) and a
  custom backend's estimator.  ``mesh=`` refuses what the reference
  refuses, and a missing card raises without recording anything.
"""

import warnings

import numpy as np
import pytest
import torch

from conftest import tiny_db
from test_torch_support import to_port
from test_torch_tree_join import _cyclic_spec

import repro.obs as ref_obs
from repro.core.backends import NumpyBackend as RefNumpyBackend
from repro.core.backends.base import Backend as RefBackend
from repro.core.cover import Cover as RefCover
from repro.core.estimators.numpy_estimator import \
    NumpyEstimator as RefNumpyEstimator
from repro.core.framework import estimate_union, warmup
from repro.core.index import Catalog as RefCatalog
from repro.core.join_sampler import JoinSampler as RefJoinSampler
from repro.core.joins import chain_join as ref_chain_join
from repro.core.online import OnlineUnionSampler as RefOnline
from repro.core.predicates import Pred as RefPred
from repro.core.predicates import RejectingPredicate as RefRejecting
from repro.core.relation import Relation as RefRelation
from repro.core.union_sampler import (BernoulliUnionSampler as RefBernoulli,
                                      DisjointUnionSampler as RefDisjoint,
                                      SetUnionSampler as RefSetUnionSampler)
from repro.data.workloads import uq1, uq2, uq3

from repro_torch import obs
from repro_torch.core.backends import (Backend, NumpyBackend, get_backend)
from repro_torch.core.backends.torch_backend import (TorchBackend,
                                                     TorchCandidateSource)
from repro_torch.core.cover import Cover
from repro_torch.core.estimators import NumpyEstimator
from repro_torch.core.index import Catalog
from repro_torch.core.join_sampler import JoinSampler
from repro_torch.core.joins import chain_join
from repro_torch.core.online import OnlineUnionSampler
from repro_torch.core.predicates import Pred, RejectingPredicate
from repro_torch.core.relation import Relation
from repro_torch.core.sharding import make_sampler_mesh
from repro_torch.core.union_sampler import (BernoulliUnionSampler,
                                            DisjointUnionSampler,
                                            SetUnionSampler)

STAT_FIELDS = ("iterations", "candidate_draws", "cover_rejects",
               "residual_rejects", "pred_rejects", "canonical_rejects",
               "revisions", "dropped_slots", "backtrack_removed",
               "samples_emitted")


def _same_set(a, b):
    assert a.attrs == b.attrs
    for attr in a.attrs:
        assert np.array_equal(a.rows[attr], b.rows[attr]), attr
    assert np.array_equal(a.home, b.home)
    assert np.array_equal(a.fingerprint, b.fingerprint)
    for f in STAT_FIELDS:
        assert getattr(a.stats, f) == getattr(b.stats, f), f


def _mark(o):
    return max([e["seq"] for e in o.fallback_events()], default=-1)


def _since(o, mark):
    return [(e["reason"], e["join"]) for e in o.fallback_events()
            if e["seq"] > mark]


# ---------------------------------------------------------------------------
# host draws
# ---------------------------------------------------------------------------


def _joins(name):
    if name == "chain":
        R, S, T = tiny_db(2)
        return [ref_chain_join("RST", [R, S, T], ["b", "c"])]
    if name == "uq3":
        return uq3(scale=0.01, overlap=0.3, seed=0).joins
    return [_cyclic_spec()[1]]          # §8.2 residual with M > 1


@pytest.mark.parametrize("name", ["chain", "uq3", "cyclic"])
@pytest.mark.parametrize("method", ["ew", "eo", "wj"])
def test_join_sampler_draws_equal_reference(name, method):
    joins = _joins(name)
    pcat, pspecs, _ = to_port(joins)
    rcat = RefCatalog()
    for j, pj in zip(joins, pspecs):
        ref = RefJoinSampler(rcat, j, method=method)
        port = JoinSampler(pcat, pj, method=method)
        assert port.is_empty() == ref.is_empty()
        assert port.root_weight_total == ref.root_weight_total
        ra, pa = np.random.default_rng(5), np.random.default_rng(5)
        for _ in range(2):
            a, b = ref.sample_batch(ra, 700), port.sample_batch(pa, 700)
            assert a.rows.keys() == b.rows.keys()
            for attr in a.rows:
                assert np.array_equal(a.rows[attr], b.rows[attr]), attr
            for f in ("ok", "accept", "prob"):
                assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert port.acceptance_rate(pa, 512) == ref.acceptance_rate(ra, 512)
        if method != "wj" and not ref.is_empty():
            a, da = ref.sample_uniform(ra, 300, batch=128)
            b, db = port.sample_uniform(pa, 300, batch=128)
            assert da == db and all(np.array_equal(a[k], b[k]) for k in a)
        assert port.residual_rejects == ref.residual_rejects
    if name == "cyclic" and method == "ew":
        assert port.residual_rejects > 0


def test_numpy_backend_and_estimator_equal_reference():
    wl = uq3(scale=0.01, overlap=0.3, seed=0)
    pcat, pspecs, _ = to_port(wl.joins)
    ref, port = RefNumpyBackend(wl.cat, wl.joins), NumpyBackend(pcat, pspecs)
    assert isinstance(port, Backend) and not port.supports_fused_rounds()
    assert get_backend(port, pcat, pspecs) is port
    ra, pa = np.random.default_rng(1), np.random.default_rng(1)
    names = [j.name for j in wl.joins]
    for n in names:
        a, da = ref.source(n).draw(ra, 200)
        b, db = port.source(n).draw(pa, 200)
        assert da == db and all(np.array_equal(a[k], b[k]) for k in a)
        assert np.array_equal(ref.oracle().membership_matrix(a, names),
                              port.oracle().membership_matrix(b, names))
    re_ = RefNumpyEstimator(wl.cat, wl.joins, seed=4, batch=128)
    pe = NumpyEstimator(pcat, pspecs, seed=4, batch=128)
    for d in (wl.joins[:1], wl.joins[:2]):
        a = re_.estimate(d, max_walks=1024)
        b = pe.estimate([pspecs[names.index(j.name)] for j in d],
                        max_walks=1024)
        assert (a.value, a.half_width, a.walks) == (b.value, b.half_width,
                                                    b.walks)
    assert pe.join_size(pspecs[0]) == re_.join_size(wl.joins[0])


# ---------------------------------------------------------------------------
# Algorithm 1 and the baselines on the host engine
# ---------------------------------------------------------------------------


def _exact(wl):
    est = estimate_union(warmup(wl.cat, wl.joins, method="exact").oracle)
    return est, to_port(wl.joins, est.cover)


@pytest.mark.parametrize("case", ["probe", "probe_eo", "record", "strict",
                                  "predicate"])
def test_set_union_numpy_equals_reference(case):
    if case == "predicate":
        wl = uq2(scale=0.02, seed=0, pred_mode="rejection")
        kw = {}
    else:
        wl = uq3(scale=0.01, overlap=0.3, seed=0)
        kw = {"probe": {}, "probe_eo": dict(join_method="eo"),
              "record": dict(membership="record"),
              "strict": dict(strict_paper_loop=True)}[case]
    est, (cat, specs, cover) = _exact(wl)
    ref = RefSetUnionSampler(wl.cat, wl.joins, est.cover, seed=7,
                             backend="numpy", **kw)
    port = SetUnionSampler(cat, specs, cover, seed=7, backend="numpy", **kw)
    assert port.engine is None and isinstance(port.backend, NumpyBackend)
    n = 150 if case in ("record", "strict") else 1200
    for _ in range(2):
        _same_set(ref.sample(n), port.sample(n))
    st = port.stats
    if case == "predicate":
        assert st.pred_rejects > 0
    if case == "record":
        assert port._record == ref._record
    assert st.cover_rejects > 0


def test_baselines_numpy_equal_reference():
    wl = uq3(scale=0.01, overlap=0.3, seed=0)
    est, (cat, specs, cover) = _exact(wl)
    sizes = dict(est.cover.join_sizes)
    U = float(est.union_size_cover)
    _same_set(RefDisjoint(wl.cat, wl.joins, sizes, seed=2).sample(900),
              DisjointUnionSampler(cat, specs, sizes, seed=2,
                                   backend="numpy").sample(900))
    _same_set(RefBernoulli(wl.cat, wl.joins, sizes, U, seed=3,
                           join_method="eo").sample(500),
              BernoulliUnionSampler(cat, specs, sizes, U, seed=3,
                                    backend="numpy",
                                    join_method="eo").sample(500))


# ---------------------------------------------------------------------------
# the six degrade paths
# ---------------------------------------------------------------------------


def _mixed_union(rel, chain, cat_cls):
    """Two one-relation joins; J_BAD holds one value at 1 << 31."""
    rng = np.random.default_rng(0)
    big = 1 << 31
    R1 = rel("R1", {"a": rng.integers(0, 8, 50), "b": rng.integers(0, 8, 50)})
    R2 = rel("R2", {"a": np.concatenate([rng.integers(0, 8, 49),
                                         np.asarray([big])]),
                    "b": rng.integers(0, 8, 50)})
    return cat_cls(), [chain("J_OK", [R1], []), chain("J_BAD", [R2], [])]


def test_degrade_mixed_union_per_join_and_host_oracle():
    cat, joins = _mixed_union(Relation, chain_join, Catalog)
    m = _mark(obs)
    with pytest.warns(UserWarning, match="fall back to host"):
        be = TorchBackend(cat, joins, device="cpu")
    assert not be.supports_fused_rounds()
    assert set(be.degraded) == {"J_BAD"} and "J_OK" in be.trees
    assert isinstance(be.source("J_OK"), TorchCandidateSource)
    assert not isinstance(be.source("J_BAD"), TorchCandidateSource)
    cover = Cover(["J_OK", "J_BAD"], {"J_OK": 50.0, "J_BAD": 50.0},
                  {"J_OK": 50.0, "J_BAD": 50.0})
    with pytest.warns(UserWarning, match="host oracle"):
        s = SetUnionSampler(cat, joins, cover, seed=3, backend=be)
        ss = s.sample(300)
    assert len(ss) == 300 and s.engine is None
    assert set(np.unique(ss.home)) == {0, 1}
    assert (ss.rows["a"] == 1 << 31).any()
    got = _since(obs, m)
    # the reference on the same union records the same reasons
    from repro.core.backends.jax_backend import JaxBackend
    rcat, rjoins = _mixed_union(RefRelation, ref_chain_join, RefCatalog)
    rm = _mark(ref_obs)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rbe = JaxBackend(rcat, rjoins)
        RefSetUnionSampler(rcat, rjoins, RefCover(
            ["J_OK", "J_BAD"], {"J_OK": 50.0, "J_BAD": 50.0},
            {"J_OK": 50.0, "J_BAD": 50.0}), seed=3, backend=rbe).sample(10)
    assert got == _since(ref_obs, rm) == [("int32_domain", "J_BAD"),
                                          ("host_oracle", "")]
    with pytest.raises(ValueError, match="fused-round backend"):
        SetUnionSampler(cat, joins, cover, backend=be,
                        mesh=make_sampler_mesh(world=1, device="cpu"))


def test_degrade_strict_loop_predicate_and_join_method():
    wl = uq3(scale=0.01, overlap=0.3, seed=0)
    est, (cat, specs, cover) = _exact(wl)
    mesh = make_sampler_mesh(world=1, device="cpu")
    cases = [(dict(strict_paper_loop=True), "strict_paper_loop", ""),
             (dict(predicate="bad"), "predicate_unsupported", specs[0].name)]
    for kw, reason, join in cases:
        pkw, rkw = dict(kw), dict(kw)
        if kw.get("predicate"):
            pkw["predicate"] = RejectingPredicate([Pred("odate", "<=",
                                                        2 ** 40)])
            rkw["predicate"] = RefRejecting([RefPred("odate", "<=", 2 ** 40)])
        m, rm = _mark(obs), _mark(ref_obs)
        s = SetUnionSampler(cat, specs, cover, seed=1, device="cpu", **pkw)
        RefSetUnionSampler(wl.cat, wl.joins, est.cover, seed=1,
                           backend="jax", **rkw)
        assert s.engine is None and isinstance(s.backend, TorchBackend)
        assert _since(obs, m) == _since(ref_obs, rm) == [(reason, join)]
        # the host loop over the card's candidate sources (B1/B2 on the card)
        ss = s.sample(120)
        assert len(ss) == 120
        assert all(isinstance(src, TorchCandidateSource)
                   for src in s.sources.values())
        mm = s.prober.membership_matrix(ss.rows, s.order)
        assert np.array_equal(np.argmax(mm, axis=1), ss.home)
        with pytest.raises(ValueError, match="mesh"):
            SetUnionSampler(cat, specs, cover, mesh=mesh, **pkw)
    m, rm = _mark(obs), _mark(ref_obs)
    with pytest.raises(ValueError, match="ew"):
        SetUnionSampler(cat, specs, cover, device="cpu", join_method="eo")
    from repro.core.backends.jax_backend import JaxBackend
    with pytest.raises(ValueError, match="ew"):
        JaxBackend(wl.cat, wl.joins, join_method="eo")
    assert _since(obs, m) == _since(ref_obs, rm) == [("join_method", "")]
    # the host engine runs EO
    ss = SetUnionSampler(cat, specs, cover, seed=1, backend="numpy",
                         join_method="eo").sample(200)
    assert len(ss) == 200


class _Custom(Backend):
    """A backend the estimator layer does not know (wraps the host one)."""

    name = "custom"

    def __init__(self, inner):
        self.inner = inner

    def source(self, join_name):
        return self.inner.source(join_name)

    def oracle(self):
        return self.inner.oracle()


class _RefCustom(RefBackend):
    name = "custom"

    def __init__(self, inner):
        self.inner = inner

    def source(self, join_name):
        return self.inner.source(join_name)

    def oracle(self):
        return self.inner.oracle()


def test_degrade_custom_backend_estimator_to_numpy():
    wl = uq3(scale=0.01, overlap=0.3, seed=0)
    cat, specs, _ = to_port(wl.joins)
    m, rm = _mark(obs), _mark(ref_obs)
    with pytest.warns(UserWarning, match="fall back to the host engine"):
        ou = OnlineUnionSampler(cat, specs, seed=5, phi=256, rw_batch=64,
                                backend=_Custom(NumpyBackend(cat, specs)))
    with pytest.warns(UserWarning, match="fall back to the host engine"):
        ro = RefOnline(wl.cat, wl.joins, seed=5, phi=256, rw_batch=64,
                       backend=_RefCustom(RefNumpyBackend(wl.cat, wl.joins)))
    assert isinstance(ou.estimator, NumpyEstimator)
    assert _since(obs, m) == _since(ref_obs, rm) == [("estimator_backend",
                                                      "")]
    # the same host decisions on the same seed: the same rows
    _same_set(ro.sample(60), ou.sample(60))
    with pytest.raises(ValueError, match="device estimator"):
        OnlineUnionSampler(cat, specs, backend="numpy",
                           mesh=make_sampler_mesh(world=1, device="cpu"))


def test_no_degrade_for_a_missing_card(monkeypatch):
    wl = uq1(scale=0.05, overlap=0.5, seed=1, n_joins=2)
    est, (cat, specs, cover) = _exact(wl)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = _mark(obs)
    for make in (lambda: TorchBackend(cat, specs),
                 lambda: SetUnionSampler(cat, specs, cover),
                 lambda: SetUnionSampler(cat, specs, cover,
                                         strict_paper_loop=True),
                 lambda: OnlineUnionSampler(cat, specs)):
        with pytest.raises(RuntimeError, match="CUDA device requested"):
            make()
    assert _since(obs, m) == []


def test_serve_cli_backend_numpy():
    from repro_torch.launch.serve import main as serve_main
    argv = ["--mode", "samples", "--backend", "numpy", "--scale", "0.05",
            "--requests", "2", "--samples", "256", "--round-batch", "1024"]
    out = serve_main(argv)
    assert out["samples"] == 512 and out["fused_rounds"] is None
    assert out["candidate_draws"] > 0 and out["host_syncs"] == 0
    with pytest.raises(ValueError, match="fused-round backend"):
        serve_main(argv + ["--shards", "1", "--device", "cpu"])
