"""The CUDA kernels against their plain versions, on the card.

Shares the sweep cases with ``test_torch_kernels.py``.  Imports neither
``jax`` nor ``repro``, so it runs on a machine that has only the port::

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_kernels_cuda.py

Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import probe


def _case(name):
    """(keys, queries) of one sweep case; keys sorted int64."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "runs_straddle_blocks":
        keys = np.repeat(np.arange(5, dtype=np.int64), 200)     # 1000 keys
        qs = np.arange(-1, 7, dtype=np.int64)
    elif name == "below_and_above":
        keys = np.sort(rng.integers(100, 200, 300))
        qs = np.array([-5, 0, 99, 100, 150, 199, 200, 10**6], np.int64)
    elif name == "dom_2_45":
        keys = np.sort(rng.integers(-2**45, 2**45, 700))
        qs = np.concatenate([rng.integers(-2**46, 2**46, 200), keys[::7]])
    elif name == "single_key":
        keys = np.array([7], np.int64)
        qs = np.array([6, 7, 8], np.int64)
    elif name == "empty_keys":
        keys = np.zeros(0, np.int64)
        qs = np.array([-1, 0, 5], np.int64)
    else:
        raise KeyError(name)
    return keys.astype(np.int64), qs.astype(np.int64)


CASES = ["runs_straddle_blocks", "below_and_above", "dom_2_45", "single_key",
         "empty_keys"]
PALLAS_CASES = ["runs_straddle_blocks", "below_and_above", "dom_2_45"]


def _dtypes(keys, qs):
    """int32 as well as int64 wherever the values fit."""
    out = [torch.int64]
    if keys.size == 0 or (np.abs(np.concatenate([keys, qs])) < 2**31).all():
        out.append(torch.int32)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernels_on_card_equal_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    keys, qs = _case(name)
    u = torch.rand(qs.shape[0], device="cuda")
    for dt in _dtypes(keys, qs):
        k = torch.as_tensor(keys, device="cuda").to(dt)
        q = torch.as_tensor(qs, device="cuda").to(dt)
        before = dict(probe.launch_counts)
        lo, hi = probe.sorted_probe(k, q)
        pos, d = probe.probe_pick(k, q, u)
        lo_p, hi_p = probe.sorted_probe_plain(k, q)
        pos_p, d_p = probe.probe_pick_plain(k, q, u)
        torch.cuda.synchronize()
        assert torch.equal(lo, lo_p) and torch.equal(hi, hi_p)
        assert torch.equal(pos, pos_p) and torch.equal(d, d_p)
        assert probe.launch_counts["sorted_probe"] == before["sorted_probe"] + 1
        assert probe.launch_counts["probe_pick"] == before["probe_pick"] + 1
