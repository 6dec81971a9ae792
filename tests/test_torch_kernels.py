"""The port's sorted probe and probe-and-pick against the Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions; these must equal
``searchsorted_pallas``/``walk_hop_pallas`` (interpret mode, tiny shapes)
and ``repro.kernels.ref`` exactly — integer outputs and the float32 pick
alike.  A CPU call launches nothing.  The CUDA kernels themselves are held
against the plain versions by ``test_torch_kernels_cuda.py`` (skipped
without a card) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.searchsorted import searchsorted_pallas
from repro.kernels.walk import walk_hop_pallas

from repro_torch.kernels import member, probe

from repro_torch.kernels.cases import (ONE_MINUS, PALLAS_PROBE_CASES,
                                       PROBE_CARD_CASES, PROBE_CASES,
                                       key_dtypes, probe_case, probe_degrees,
                                       probe_uniforms)


@pytest.mark.parametrize("name", PROBE_CASES)
def test_sorted_probe_plain_equals_reference(name):
    keys, qs = probe_case(name)
    lo_r, hi_r = ref.searchsorted_ref(keys, qs)
    if name in PALLAS_PROBE_CASES:
        lo_p, hi_p = searchsorted_pallas(keys, qs, interpret=True)
        assert np.array_equal(lo_p, lo_r) and np.array_equal(hi_p, hi_r)
    for dt in key_dtypes(keys, qs):
        lo, hi = probe.sorted_probe(torch.as_tensor(keys).to(dt),
                                    torch.as_tensor(qs).to(dt))
        assert lo.dtype == hi.dtype == torch.int32
        assert np.array_equal(lo.numpy(), lo_r), dt
        assert np.array_equal(hi.numpy(), hi_r), dt


def _check_uniforms(name, keys, qs, u):
    """0 and 1⁻ at every fifth query; at every fifth a u whose float32
    product with the query's degree is an integer k in [0, d), with k > 0
    wherever d > 1; seeded, so each check draws the same values."""
    assert u.dtype == np.float32 and u.shape == qs.shape
    assert np.array_equal(u, probe_uniforms(name, qs.shape[0]))
    assert ((u >= 0) & (u < 1)).all()
    assert (u[0::5] == 0).all() and (u[1::5] == ONE_MINUS).all()
    d = probe_degrees(keys, qs[2::5])
    k = u[2::5] * np.maximum(d, 1).astype(np.float32)     # float32 product
    assert (k == np.floor(k)).all() and (k < np.maximum(d, 1)).all()
    assert (k[d > 1] > 0).all()
    if name in ("runs_straddle_splitters", "large_2_20"):
        # the exact product lies below k: floor of it would give k - 1
        assert (u[2::5].astype(np.float64) * d < k).any()
    with pytest.raises(ValueError):
        probe_uniforms(name, qs.shape[0] + 1)


@pytest.mark.parametrize("name", PROBE_CASES)
def test_probe_pick_plain_equals_reference(name):
    keys, qs = probe_case(name)
    u = probe_uniforms(name, qs.shape[0])
    _check_uniforms(name, keys, qs, u)
    pos_r, d_r = ref.walk_hop_ref(keys, qs, u)
    lo_r, _ = ref.searchsorted_ref(keys, qs)
    # hop_refine_pick_kernel's float32 pick on the reference's range;
    # walk_hop_ref multiplies u by an int64 degree, which numpy does in
    # float64, so it gives k - 1 where the float32 product rounds up to k:
    # only at the uniforms that land on an integer
    pick = lo_r + np.minimum(
        np.floor(u * np.maximum(d_r, 1).astype(np.float32)).astype(np.int64),
        np.maximum(d_r - 1, 0))
    apart = np.flatnonzero(pick != pos_r)
    assert (apart % 5 == 2).all() and (pick[apart] == pos_r[apart] + 1).all()
    for dt in key_dtypes(keys, qs):
        pos, d = probe.probe_pick(torch.as_tensor(keys).to(dt),
                                  torch.as_tensor(qs).to(dt),
                                  torch.as_tensor(u))
        assert np.array_equal(d.numpy(), d_r)
        # unclipped contract: a dead query (d == 0) gets pos = lo
        assert np.array_equal(pos.numpy(), pick)
    if name in PALLAS_PROBE_CASES:
        pos_p, d_p = walk_hop_pallas(keys, qs, u, interpret=True)
        assert np.array_equal(d_p, d_r)
        # walk_hop_pallas clips to n - 1 for its host caller
        assert np.array_equal(pos_p, np.minimum(pick, keys.shape[0] - 1))


def test_card_probe_uniforms_hold_edge_values():
    """The card's probe cases draw uniforms with the same edge values."""
    for name in PROBE_CARD_CASES:
        keys, qs = probe_case(name)
        _check_uniforms(name, keys, qs, probe_uniforms(name, qs.shape[0]))


def test_pick_float32_rounding_matches_reference():
    """u·d rounds up to d in float32 for u just below 1: the clamp to d-1
    must agree with the reference's float32 arithmetic."""
    d = np.arange(0, 5000, dtype=np.int64)
    lo = np.zeros_like(d)
    u = np.full(d.shape, np.nextafter(np.float32(1), np.float32(0)), np.float32)
    want = lo + np.minimum(np.floor(u * np.maximum(d, 1).astype(np.float32))
                           .astype(np.int64), np.maximum(d - 1, 0))
    got = probe.pick_from_range(torch.as_tensor(lo, dtype=torch.int32),
                                torch.as_tensor(d, dtype=torch.int32),
                                torch.as_tensor(u))
    assert np.array_equal(got.numpy(), want)


def test_cpu_tensors_launch_nothing():
    probe.reset_launch_counts()
    keys = torch.arange(0, 100, 3, dtype=torch.int32)
    q = torch.tensor([1, 3, 99], dtype=torch.int32)
    probe.sorted_probe(keys, q)
    probe.probe_pick(keys, q, torch.rand(3))
    plan = member.MemberPlan([[member.relation_index(("a",), [keys], "cpu")]])
    member.member_lookup(plan, {"a": q})
    assert probe.launch_counts == {"sorted_probe": 0, "probe_pick": 0,
                                   "segdegree": 0, "decode_attention": 0,
                                   "member_lookup": 0}


@pytest.mark.parametrize("bad", ["dtype", "rank", "u_dtype"])
def test_wrappers_reject_bad_inputs(bad):
    keys = torch.arange(10, dtype=torch.int32)
    q = torch.arange(4, dtype=torch.int32)
    u = torch.rand(4)
    if bad == "dtype":
        with pytest.raises(ValueError):
            probe.sorted_probe(keys, q.long())
    elif bad == "rank":
        with pytest.raises(ValueError):
            probe.sorted_probe(keys.view(2, 5), q)
    else:
        with pytest.raises(ValueError):
            probe.probe_pick(keys, q, u.double())
