"""The port's ONLINE-UNION sampler (Algorithm 2) against the reference's.

* With the estimator's walks and every candidate source's rounds replayed
  from the reference's JAX keys (``JaxOnlineReplay``) and the same host
  seed, ``OnlineUnionSampler(backend="torch")`` equals
  ``OnlineUnionSampler(backend="jax")`` over several ``sample(n)`` calls:
  emitted rows, ``home``, every ``SamplerStats`` counter, refresh and
  backtrack counts exactly, the refresh events' union sizes within rel 1e-5
  (float32 means), under ``plan="static"`` and ``"adaptive"``, on UQ3 and
  UQ4 and with a union-wide rejection predicate.
* With its own Philox streams the port meets the reference's bar for
  Algorithm 2 (``tests/test_union.py::test_online_union_end_to_end``).
* Unknown backends and a non-torch estimator raise.
"""

import numpy as np
import pytest

from test_torch_support import JaxOnlineReplay, to_port

from repro.core.online import OnlineUnionSampler as RefOnline
from repro.core.overlap import exact_union_size
from repro.core.predicates import Pred as RefPred
from repro.core.predicates import RejectingPredicate as RefRejecting
from repro.data.workloads import uq3, uq4

from repro_torch.core.estimators import TorchEstimator
from repro_torch.core.online import OnlineUnionSampler
from repro_torch.core.predicates import Pred, RejectingPredicate

STAT_FIELDS = ("iterations", "candidate_draws", "cover_rejects",
               "residual_rejects", "pred_rejects", "canonical_rejects",
               "revisions", "dropped_slots", "reuse_accepts", "reuse_rejects",
               "backtrack_removed", "samples_emitted")


def _case(name):
    """(workload, OnlineUnionSampler kwargs, sample sizes)."""
    if name.startswith("uq3"):
        # phi small enough for several refreshes on three overlapping joins
        kw = dict(phi=64)
        if name == "uq3_predicate":
            kw["predicate"] = ("nk", "<=", 20)
        return uq3(scale=0.01), kw, (120, 240)
    # UQ4's chain lies inside the cyclic join, so the chain pivot's overlap
    # walks have zero variance: γ holds after the first refresh, and there
    # is exactly one.  Chain first: the cyclic piece is probed against it
    return (uq4(scale=0.05, seed=0),
            dict(phi=32, order=["UQ4_CHAIN", "UQ4_CYC"]), (120, 240))


@pytest.mark.parametrize("name,plan", [
    ("uq3", "static"), ("uq3", "adaptive"), ("uq4", "static"),
    ("uq4", "adaptive"), ("uq3_predicate", "static")])
def test_online_equals_reference_under_replay(name, plan):
    wl, kw, sizes = _case(name)
    pkw = dict(kw)
    if "predicate" in kw:
        kw["predicate"] = RefRejecting([RefPred(*kw["predicate"])])
        pkw["predicate"] = RejectingPredicate([Pred(*pkw["predicate"])])
    ref = RefOnline(wl.cat, wl.joins, seed=3, rw_batch=64, backend="jax",
                    plan=plan, **kw)
    cat, specs, _ = to_port(wl.joins)
    port = OnlineUnionSampler(cat, specs, seed=3, rw_batch=64, plan=plan,
                              device="cpu", uniforms=JaxOnlineReplay(3), **pkw)
    assert port.order == ref.order
    assert port.cover.piece_sizes == ref.cover.piece_sizes
    for n in sizes:
        a, b = ref.sample(n), port.sample(n)
        assert len(b) == n and b.rows[port.attrs[0]].dtype == np.int64
        assert np.array_equal(a.matrix(), b.matrix())
        assert np.array_equal(a.home, b.home)
        assert np.array_equal(a.fingerprint, b.fingerprint)
        for f in STAT_FIELDS:
            assert getattr(a.stats, f) == getattr(b.stats, f), f
        assert port.refresh_count == ref.refresh_count
        assert port.backtrack_count == ref.backtrack_count
    ev_a, ev_b = ref.trace.events("refresh"), port.trace.events("refresh")
    assert len(ev_a) == len(ev_b) == port.refresh_count
    for x, y in zip(ev_a, ev_b):
        assert y["union_size"] == pytest.approx(x["union_size"], rel=1e-5)
        assert (y["kept"], y["removed"], y["confident"]) == \
            (x["kept"], x["removed"], x["confident"])
        for j in port.names:
            assert y["hist_gap"][j] == pytest.approx(x["hist_gap"][j],
                                                     rel=1e-5, abs=1e-9)
    assert port.trace.events("init")[0]["union_size"] == \
        ref.trace.events("init")[0]["union_size"]
    st = b.stats
    assert st.reuse_accepts > 0 and st.cover_rejects > 0
    if name.startswith("uq3"):
        assert port.refresh_count >= 2 and port.backtrack_count > 0
    else:
        assert port.refresh_count == 1
    if name == "uq3_predicate":
        assert st.pred_rejects > 0
        assert (b.rows["nk"] <= 20).all()


def test_online_philox_meets_the_reference_bar():
    wl = uq3(scale=0.01, overlap=0.3, seed=0)
    cat, specs, _ = to_port(wl.joins)
    ou = OnlineUnionSampler(cat, specs, seed=12, phi=512, rw_batch=128,
                            device="cpu")
    assert isinstance(ou.estimator, TorchEstimator)
    # the estimator probes through the sampling backend's membership indexes
    assert ou.estimator.members is ou.backend.members
    U = exact_union_size(wl.cat, wl.joins)
    ss = ou.sample(40 * U)
    assert len(ss) == 40 * U
    assert ss.stats.reuse_accepts > 0
    mat = ss.matrix()
    uni, counts = np.unique(mat.view([("", mat.dtype)] * mat.shape[1]).ravel(),
                            return_counts=True)
    assert uni.shape[0] >= 0.9 * U
    assert counts.max() <= 12 * counts.mean()
    # every row lies in its home piece and in no earlier piece
    mm = ou.prober.membership_matrix(ss.rows, ou.order)
    assert mm.any(axis=1).all()
    assert np.array_equal(np.argmax(mm, axis=1), ss.home)


def test_online_rejects_what_the_port_does_not_run():
    wl = uq3(scale=0.01)
    cat, specs, _ = to_port(wl.joins)
    for kw, match in ((dict(backend="jax"), "unknown backend"),
                      (dict(backend="gpu"), "unknown backend"),
                      (dict(estimator="gpu"), "unknown estimator backend"),
                      (dict(estimator="jax"), "unknown estimator backend"),
                      (dict(plan="eager"), "plan")):
        with pytest.raises(ValueError, match=match):
            OnlineUnionSampler(cat, specs, device="cpu", **kw)
