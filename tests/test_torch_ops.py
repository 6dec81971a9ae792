"""The port's kernel entry point ``repro_torch.kernels.ops`` against the
reference's ``repro.kernels.ops``.

On the CPU every wrapper runs its plain PyTorch version.  ``segdegree`` must
equal ``segdegree_pallas`` (interpret mode) and ``segdegree_ref`` exactly;
``decode_attention`` must be within 2e-5 (f32), or rtol 1e-2 and atol 1e-3
(bf16), of ``decode_attention_pallas`` on the same inputs; ``searchsorted``,
``walk_hop`` and ``ranged_weighted_pick`` must equal the reference's
functions exactly.  The CUDA kernels themselves are held against the plain
versions by ``test_torch_kernels_cuda.py`` (skipped without a card) and by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.attention import decode_attention_pallas
from repro.kernels.segdegree import segdegree_pallas

from repro_torch.kernels import ops

from repro_torch.kernels.cases import (ATTENTION_SHAPES, PALLAS_PROBE_CASES,
                                       PROBE_CASES, SEGDEGREE_CARD_CASES,
                                       SEGDEGREE_CASES, attention_case,
                                       attention_tol, key_dtypes, probe_case,
                                       segdegree_card_case, segdegree_keys)


@pytest.mark.parametrize("name", SEGDEGREE_CASES)
def test_segdegree_equals_reference(name):
    keys = segdegree_keys(name)
    want = ref.segdegree_ref(keys)
    assert segdegree_pallas(keys, interpret=True) == want
    for dt in key_dtypes(keys):
        got = ops.segdegree(torch.as_tensor(keys).to(dt), device="cpu")
        assert got == want, dt
        assert all(type(x) is int for x in got)


@pytest.mark.parametrize("name", SEGDEGREE_CARD_CASES)
def test_segdegree_card_cases_equal_reference(name):
    """The card's edge cases (views, short columns, CTA-range boundaries)
    through the plain version on the CPU; ``cta_keys`` stands in for the
    card's CTA ranges (the card's tests use the kernel's own)."""
    base, off = segdegree_card_case(name, lambda n: 3072)
    want = ref.segdegree_ref(base[off:])
    for dt in key_dtypes(base):
        col = torch.as_tensor(base).to(dt)[off:]
        assert ops.segdegree(col, device="cpu") == want, dt


def _pallas_attention(q, k, v, lens, cap, win):
    return np.asarray(decode_attention_pallas(q, k, v, lens, softcap=cap,
                                              window=win, interpret=True),
                      np.float32)


def _check_attention(case):
    """The port on the CPU against the Pallas kernel (interpret mode) on the
    same inputs, in the case's dtype; returns the port's output in fp32."""
    c = attention_case(case)
    dt, cap, win, lens = c["dtype"], c["softcap"], c["window"], c["lens"]
    q, k, v = c["q"], c["k"], c["v"]
    if dt == torch.bfloat16:
        q, k, v = (x.astype(jnp.bfloat16) for x in (q, k, v))
    got = ops.decode_attention(
        *(torch.as_tensor(np.asarray(x, np.float32)).to(dt) for x in (q, k, v)),
        lens, softcap=cap, window=win, device="cpu")
    assert got.dtype == dt and got.shape == c["q"].shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, _pallas_attention(q, k, v, lens, cap, win),
                               **attention_tol(dt))
    return got


@pytest.mark.parametrize("shape", ATTENTION_SHAPES)
def test_decode_attention_f32_matches_pallas(shape):
    _check_attention(f"shape_{ATTENTION_SHAPES.index(shape)}")


def test_decode_attention_bf16_matches_pallas():
    _check_attention("bf16")


@pytest.mark.parametrize("case", ["length_0", "shorter_than_window",
                                  "head_mapping", "softcap_range",
                                  "softcap_range_bf16", "skewed_lengths",
                                  "many_pairs", "all_zero_lengths"])
def test_decode_attention_edges_match_pallas(case):
    got = _check_attention(case)
    if case == "length_0":
        assert not got[0].any()
    elif case == "skewed_lengths":
        assert not got[1].any() and got[2:].any()
    elif case == "all_zero_lengths":
        assert not got.any()
    elif case == "head_mapping":
        # query head h reads KV head h // G, whose values are all h // G + 1
        heads = attention_case(case)["heads"]
        np.testing.assert_allclose(got[0], np.broadcast_to(
            heads[:, None].astype(np.float32), got[0].shape), rtol=1e-6)


@pytest.mark.parametrize("name", PROBE_CASES)
def test_searchsorted_and_walk_hop_equal_reference_ops(name):
    keys, qs = probe_case(name)
    rng = np.random.default_rng(len(name))
    u = rng.random(qs.shape[0]).astype(np.float32)
    if name in PALLAS_PROBE_CASES:
        lo_r, hi_r = jops.searchsorted(keys, qs)
        pos_r, deg_r = jops.walk_hop(keys, qs, u)
    else:           # the reference's kernels need at least two key blocks
        lo_r, hi_r = ref.searchsorted_ref(keys, qs)
        pos_r, deg_r = ref.walk_hop_ref(keys, qs, u)
        pos_r = np.minimum(pos_r, max(keys.shape[0] - 1, 0))
    for dt in key_dtypes(keys, qs):
        k, q = torch.as_tensor(keys).to(dt), torch.as_tensor(qs).to(dt)
        lo, hi = ops.searchsorted(k, q, device="cpu")
        pos, deg = ops.walk_hop(k, q, u, device="cpu")
        assert np.array_equal(lo.numpy(), lo_r) and np.array_equal(hi.numpy(), hi_r)
        assert np.array_equal(pos.numpy(), pos_r), dt
        assert np.array_equal(deg.numpy(), deg_r), dt


def _pick_inputs(seed):
    """The draws of ``test_ranged_weighted_pick``; seed -1 gives those of
    ``test_ranged_weighted_pick_distribution``."""
    if seed < 0:
        w = np.array([1.0, 0.0, 3.0, 0.0, 6.0])
        N = 30_000
        return (np.concatenate([[0.0], np.cumsum(w)]), np.zeros(N, np.int64),
                np.full(N, 5, np.int64), np.random.default_rng(0).random(N))
    rng = np.random.default_rng(seed)
    n = 500
    w = rng.random(n)
    w[rng.random(n) < 0.3] = 0.0
    lo = rng.integers(0, n - 50, 200)
    return (np.concatenate([[0.0], np.cumsum(w)]), lo,
            lo + rng.integers(1, 50, 200), rng.random(200))


@pytest.mark.parametrize("seed", [0, 1, 2, -1])
def test_ranged_weighted_pick_equals_reference_ops(seed):
    cs, lo, hi, u = _pick_inputs(seed)
    got = ops.ranged_weighted_pick(cs, lo, hi, u, device="cpu")
    want = jops.ranged_weighted_pick(cs, lo, hi, u)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want)
