"""Device membership of the port equals the reference exactly.

The port's int64-masked ``mix32``/``fp32`` equal the reference's uint32
``mix32_np``/``fp32_np``; ``TorchJoinMembership.contains`` and the oracle's
``membership_matrix`` equal ``DeviceJoinMembership.contains`` and the host
``MembershipProber`` on member rows and on perturbed non-member rows.
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
