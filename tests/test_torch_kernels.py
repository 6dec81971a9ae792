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

from repro_torch.kernels import probe

from repro_torch.kernels.cases import (PALLAS_PROBE_CASES, PROBE_CASES,
                                       key_dtypes, probe_case)


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


@pytest.mark.parametrize("name", PROBE_CASES)
def test_probe_pick_plain_equals_reference(name):
    keys, qs = probe_case(name)
    rng = np.random.default_rng(len(name))
    u = rng.random(qs.shape[0]).astype(np.float32)
    u[:2] = np.float32(np.nextafter(np.float32(1), np.float32(0)))  # u → 1⁻
    pos_r, d_r = ref.walk_hop_ref(keys, qs, u)
    for dt in key_dtypes(keys, qs):
        pos, d = probe.probe_pick(torch.as_tensor(keys).to(dt),
                                  torch.as_tensor(qs).to(dt),
                                  torch.as_tensor(u))
        assert np.array_equal(d.numpy(), d_r)
        # unclipped contract: a dead query (d == 0) gets pos = lo
        assert np.array_equal(pos.numpy(), pos_r)
    if name in PALLAS_PROBE_CASES:
        pos_p, d_p = walk_hop_pallas(keys, qs, u, interpret=True)
        assert np.array_equal(d_p, d_r)
        # walk_hop_pallas clips to n - 1 for its host caller
        assert np.array_equal(pos_p, np.minimum(pos_r, keys.shape[0] - 1))


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
    assert probe.launch_counts == {"sorted_probe": 0, "probe_pick": 0,
                                   "segdegree": 0, "decode_attention": 0}


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
