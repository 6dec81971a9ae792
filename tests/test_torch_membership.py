"""Device membership of the port equals the reference exactly.

The port's int64-masked ``mix32``/``fp32`` equal the reference's uint32
``mix32_np``/``fp32_np``; ``TorchJoinMembership.contains`` and the oracle's
``membership_matrix`` equal ``DeviceJoinMembership.contains`` and the host
``MembershipProber`` on member rows and on perturbed non-member rows.  The
round's earlier-piece lookup (``kernels/member.py``'s plain version, the
kernel's comparison target on the card) drops exactly the live candidates
that an exact tuple-set test puts in an earlier piece, and counts the live
candidates times the pieces.
"""

import jax
import numpy as np
import pytest
import torch

from test_torch_support import to_port

from repro.core.backends.jax_backend import (DeviceJoinMembership, fp32_np,
                                             mix32_np)
from repro.core.joins import full_join_matrix
from repro.core.membership import MembershipProber
from repro.data.workloads import uq1, uq4

from repro_torch.core.backends.torch_backend import (TorchBackend,
                                                     TorchJoinMembership, fp32,
                                                     mix32)
from repro_torch.kernels import member
from repro_torch.kernels.cases import (MEMBER_CASES, MEMBER_LAUNCHES,
                                       member_case, member_plan)


@pytest.mark.parametrize("salt", [0, 1, 2, 7])
def test_mix32_and_fp32_equal_reference(salt):
    rng = np.random.default_rng(salt)
    cols = [rng.integers(0, 2**31, 5000) for _ in range(3)]
    cols[0][:4] = [0, 1, 2**31 - 1, 2**31 - 2]
    got = mix32(torch.as_tensor(cols[0]), salt=salt).numpy()
    assert np.array_equal(got, mix32_np(cols[0], salt=salt).astype(np.int64))
    got = fp32([torch.as_tensor(c) for c in cols], salt).numpy()
    assert np.array_equal(got, fp32_np(cols, salt).astype(np.int64))


@pytest.fixture(scope="module", params=["uq1", "uq4"])
def union(request):
    if request.param == "uq1":
        wl = uq1(scale=0.05, overlap=0.4, seed=1)
    else:
        wl = uq4(scale=0.05, seed=0)
    cat, specs, _ = to_port(wl.joins)
    rng = np.random.default_rng(4)
    attrs = list(wl.joins[0].output_attrs)
    mats = [full_join_matrix(wl.cat, j, attrs) for j in wl.joins]
    members = np.concatenate([m[rng.integers(0, m.shape[0], 150)]
                              for m in mats if m.shape[0]])
    # perturbed copies: one attribute moved by one (mostly non-members)
    pert = members.copy()
    col = rng.integers(0, pert.shape[1], pert.shape[0])
    pert[np.arange(pert.shape[0]), col] += 1
    probe = np.concatenate([members, pert])
    rows = {a: probe[:, i] for i, a in enumerate(attrs)}
    return wl, cat, specs, rows


def test_contains_equals_device_and_host_reference(union):
    wl, cat, specs, rows = union
    host = MembershipProber(wl.cat, wl.joins)
    dev_rows = {a: jax.numpy.asarray(c.astype(np.int32)) for a, c in rows.items()}
    pt_rows = {a: torch.as_tensor(c.astype(np.int32)) for a, c in rows.items()}
    fp_cache = {}
    for rj, pj in zip(wl.joins, specs):
        want = host.contains(rj.name, rows)
        assert 0 < want.sum() < want.shape[0]
        ref = np.asarray(jax.jit(DeviceJoinMembership(rj).contains)(dev_rows))
        got = TorchJoinMembership(pj, device="cpu").contains(pt_rows)
        cached = TorchJoinMembership(pj, device="cpu").contains(pt_rows, fp_cache)
        assert np.array_equal(ref, want)
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(cached.numpy(), want)


def test_membership_matrix_equals_host_prober(union):
    wl, cat, specs, rows = union
    want = MembershipProber(wl.cat, wl.joins).membership_matrix(rows)
    got = TorchBackend(cat, specs, device="cpu").oracle().membership_matrix(rows)
    assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the round's earlier-piece lookup (kernels/member.py, plain version)
# ---------------------------------------------------------------------------


def _brute_contains(case, q):
    """Exact membership in piece ``q``: every relation holds the row's
    projection (tuple sets, no fingerprints), and q's predicate."""
    rows = case["rows"]
    b = next(iter(rows.values())).shape[0]
    res = np.ones(b, bool) if case["preds"][q] is None else case["preds"][q].copy()
    for attrs, rel in case["pieces"][q]:
        have = set(map(tuple, rel.tolist()))
        proj = np.stack([rows[a] for a in attrs], axis=1).tolist()
        res &= np.array([tuple(t) in have for t in proj], bool)
    return res


@pytest.mark.parametrize("name", MEMBER_CASES)
def test_member_lookup_plain_drops_rows_of_every_earlier_piece(name):
    case = member_case(name)
    plan, rows, acc, preds = member_plan(case, "cpu")
    out, lookups = member.member_lookup(plan, rows, acc, preds)
    b = next(iter(rows.values())).shape[0]
    live = np.ones(b, bool) if case["acc"] is None else case["acc"]
    want = live.copy()
    for q in range(len(case["pieces"])):
        inside = _brute_contains(case, q)
        want &= ~inside
        # contains of one piece alone, with and without a shared cache
        one = member.MemberPlan([plan.pieces[q]])
        got = member.contains(one, rows, preds[q])
        assert np.array_equal(got.numpy(), inside), q
        assert np.array_equal(member.contains(one, rows, preds[q], {}).numpy(),
                              inside), q
    assert out.dtype == torch.bool
    assert np.array_equal(out.numpy(), want)
    # the (live candidate, earlier piece) pairs looked up: dead ones never
    assert lookups.dtype == torch.int64 and lookups.dim() == 0
    assert int(lookups) == int(live.sum()) * len(case["pieces"])
    # the runs of pieces the card launches: one, two past its capacities
    assert plan.launches == MEMBER_LAUNCHES.get(
        name, [(0, len(case["pieces"]))])
    if name == "dup_window":
        # both salt-1 twins share a run; only the one in the relation hits
        assert plan.pieces[0][0][3] >= 2
        s1 = plan.pieces[0][0][1]
        assert len(set(s1.tolist())) < s1.shape[0]


@pytest.mark.parametrize("shape, runs", [
    # 13 pieces of 5 relations over 3 columns: 65 relations, past 64
    ((13, 5, 3, 3), [(0, 12), (12, 13)]),
    # 17 pieces of one relation
    ((17, 1, 2, 2), [(0, 16), (16, 17)]),
    # each piece's 2 relations read 20 columns of their own: 100 past 96
    ((5, 2, 10, 1000), [(0, 4), (4, 5)]),
    # 3 pieces of 2 relations, each relation 50 of 60 columns: 300 column
    # slots past 256 (the 60 columns fit)
    ((3, 2, 50, 60), [(0, 2), (2, 3)]),
    # one piece past every capacity alone: its own run (its launch raises)
    ((1, 70, 1, 1), [(0, 1)]),
])
def test_member_plan_splits_past_one_launch(shape, runs):
    """A plan past one launch's pieces, relations, columns or column slots
    runs as consecutive runs of pieces, each as long as a launch allows.
    Relation r of piece q reads ``width`` consecutive columns of a pool,
    from column (q * nrels + r) * width on."""
    npieces, nrels, width, pool = shape
    empty = torch.zeros(0, dtype=torch.int64)
    pieces = [[(tuple(sorted(f"c{((q * nrels + r) * width + i) % pool:04d}"
                             for i in range(width))), empty, empty, 0, 0)
               for r in range(nrels)] for q in range(npieces)]
    assert member.MemberPlan(pieces).launches == runs


def test_engine_counts_member_lookups_of_live_candidates():
    """Piece 0 is never looked up; every later piece's live candidates are,
    once per earlier piece, and the host loop counts the same."""
    wl = uq1(scale=0.05, overlap=0.4, seed=1)
    cat, specs, _ = to_port(wl.joins)
    from repro_torch.core.framework import estimate_union, warmup
    from repro_torch.core.union_sampler import SetUnionSampler
    cover = estimate_union(warmup(cat, specs, method="histogram").oracle).cover
    dev, host = [SetUnionSampler(cat, specs, cover, seed=5, device="cpu",
                                 round_batch=512, fused_rounds=mode)
                 for mode in ("device", "host")]
    a, b = dev.sample(700), host.sample(700)
    st = a.stats
    assert st.member_lookups == b.stats.member_lookups > 0
    nj = len(specs)
    assert st.member_lookups <= st.candidate_draws * (nj - 1)


def test_member_lookups_reader_reads_the_counter_or_nothing():
    """``round.member_lookups_per_sample``: the window's lookups per sample
    emitted; nothing where the program does not count lookups (a parent
    commit) or emitted nothing."""
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "unionbench"
            / "metrics" / "round.member_lookups_per_sample.py")
    spec = importlib.util.spec_from_file_location("member_reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class Run:
        def __init__(self, before, after):
            self.before, self.after = before, after

        def delta(self, key):
            return self.after.get(key, 0.0) - self.before.get(key, 0.0)

    both = dict(samples_emitted=1000.0, member_lookups=300.0)
    assert mod.read(Run(both, dict(samples_emitted=9000.0,
                                   member_lookups=2700.0))) == 0.3
    assert mod.read(Run({"samples_emitted": 0.0},
                        {"samples_emitted": 10.0})) is None
    assert mod.read(Run(both, both)) is None
