"""Record-mode membership (the lazy ``orig_join`` record) in the port.

* Under replayed uniforms (the record engine's own key schedule,
  ``JaxRecordReplay``) and the same host multinomial stream,
  ``TorchRecordUnionSampler`` over three ``sample(n)`` calls equals
  ``SetUnionSampler(backend="jax", membership="record")``: the multiset of
  ``(row, home)``, every ``SamplerStats`` counter (``revisions`` and
  ``backtrack_removed`` included), ``piece_stats``, the rounds and the final
  record ``{fingerprint: (home, credited rows)}``.  On UQ2 pushdown and on
  two rejection flavours of partsupp ⋈ part whose predicate windows overlap,
  where a later piece claims tuples an earlier piece then re-draws.
* The port's own stream in record mode is uniform over the exact union
  (chi-square).
* ``plan="adaptive"`` with record mode raises, as in the reference.
"""

import numpy as np
import pytest
from scipy import stats as sps

from test_torch_support import JaxRecordReplay, sample_multiset, to_port

from repro.core.framework import estimate_union, warmup
from repro.core.index import Catalog
from repro.core.joins import chain_join
from repro.core.overlap import exact_union_size
from repro.core.predicates import Pred, rejection
from repro.core.union_sampler import SetUnionSampler as RefSetUnionSampler
from repro.data.tpch import generate
from repro.data.workloads import uq2

from repro_torch.core.backends.torch_backend import TorchRecordUnionSampler
from repro_torch.core.union_sampler import SetUnionSampler

STAT_FIELDS = ("iterations", "candidate_draws", "cover_rejects",
               "residual_rejects", "pred_rejects", "dropped_slots",
               "samples_emitted", "revisions", "backtrack_removed")


def _uq2_pushdown():
    wl = uq2(scale=0.02, seed=0, pred_mode="pushdown")
    return wl.cat, wl.joins, estimate_union(
        warmup(wl.cat, wl.joins, method="exact").oracle)


def _revision_workload():
    """Two rejection flavours of partsupp ⋈ part whose predicate windows
    overlap on the middle psize quintile."""
    db = generate(0.1, seed=1)
    base = chain_join("PSP", [db["partsupp"], db["part"]], [("pk",)])
    ps = db["part"].columns["psize"]
    lo, hi = int(np.percentile(ps, 40)), int(np.percentile(ps, 60))
    j1 = rejection(base, [Pred("psize", "<=", hi)], name="PSP_LOW")
    j2 = rejection(base, [Pred("psize", ">=", lo)], name="PSP_HIGH")
    cat = Catalog()
    return cat, [j1, j2], estimate_union(warmup(cat, [j1, j2],
                                                method="exact").oracle)


@pytest.mark.parametrize("name,rb,ns", [
    ("uq2_pushdown", 512, (1100, 2048, 1500)),
    ("revisions", 64, (400, 700, 500))])
def test_record_equals_reference_under_replayed_uniforms(name, rb, ns):
    cat_ref, joins, est = (_uq2_pushdown() if name == "uq2_pushdown"
                           else _revision_workload())
    ref = RefSetUnionSampler(cat_ref, joins, est.cover, seed=3,
                             backend="jax", round_batch=rb,
                             membership="record")
    cat, specs, cover = to_port(joins, est.cover)
    port = SetUnionSampler(cat, specs, cover, seed=3, device="cpu",
                           round_batch=rb, membership="record",
                           uniforms=JaxRecordReplay(3))
    assert isinstance(port.engine, TorchRecordUnionSampler)
    assert port.engine.piece_batches == ref._engine.piece_batches
    for n in ns:
        a, b = ref.sample(n), port.sample(n)
        assert len(b) == n
        assert np.array_equal(sample_multiset(a), sample_multiset(b))
        for f in STAT_FIELDS:
            assert getattr(a.stats, f) == getattr(b.stats, f), f
        assert np.array_equal(ref._engine.piece_stats, port.engine.piece_stats)
        assert ref._engine.last_rounds == port.engine.last_rounds
        assert port.engine.last_host_syncs == port.engine.last_rounds + 1
    assert port.engine.record_dict() == ref._engine.record_dict()
    assert b.stats.revisions > 0 and b.stats.backtrack_removed > 0
    if name == "revisions":
        assert b.stats.pred_rejects > 0


def test_record_stream_uniform_over_exact_union():
    cat_ref, joins, est = _uq2_pushdown()
    U = exact_union_size(cat_ref, joins)
    cat, specs, cover = to_port(joins, est.cover)
    s = SetUnionSampler(cat, specs, cover, seed=13, device="cpu",
                        round_batch=2048, membership="record")
    N = 60 * U
    ss = s.sample(N)
    m = ss.matrix()
    uni, counts = np.unique(m.view([("", m.dtype)] * m.shape[1]).ravel(),
                            return_counts=True)
    assert uni.shape[0] <= U
    exp = N / U
    chi2 = float(((counts - exp) ** 2 / exp).sum()) + (U - uni.shape[0]) * exp
    p = 1 - sps.chi2.cdf(chi2, df=U - 1)
    assert p > 1e-3, f"record mode not uniform over the union (p={p})"
    # every settled row lies in its home piece.  The lazy record credits a
    # tuple to the first piece that has drawn it so far, so in general a
    # row may sit in a later piece that holds it; at N = 60·U every tuple's
    # first piece has drawn it before the call settles, so here the home is
    # also the first piece that holds it
    mm = s.prober.membership_matrix(ss.rows, s.order)
    assert mm[np.arange(ss.home.size), ss.home].all()
    assert np.array_equal(np.argmax(mm, axis=1), ss.home)


def test_record_mode_refuses_adaptive_plan():
    cat_ref, joins, est = _uq2_pushdown()
    cat, specs, cover = to_port(joins, est.cover)
    with pytest.raises(ValueError, match="plan='static' only"):
        SetUnionSampler(cat, specs, cover, device="cpu", membership="record",
                        plan="adaptive")
    with pytest.raises(ValueError, match="membership"):
        SetUnionSampler(cat, specs, cover, device="cpu", membership="lazy")
