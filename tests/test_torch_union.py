"""The port's Algorithm-1 engine as a whole against the reference.

* With uniforms replayed from the reference's key schedule,
  ``TorchUnionSampler`` in either loop mode (``fused_rounds="device"``, the
  default, and ``"host"``) over several ``sample(n)`` calls (bank carry
  between them) equals ``JaxUnionSampler(plan="static", fused_rounds="device")`` in
  the multiset of ``(row, home)`` (only the output shuffle differs), the six
  ``SamplerStats`` counters, the per-piece counters and the round counts.
* The port's own Philox stream is uniform over the exact union (chi-square).
* The serve CLI runs on the CPU when asked to.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
from scipy import stats as sps

from test_torch_support import (JaxReplay, sample_multiset, to_port,
                                union_setup)

from repro.core.framework import estimate_union, warmup
from repro.core.overlap import exact_union_size
from repro.core.union_sampler import SetUnionSampler as RefSetUnionSampler
from repro.data.workloads import uq1

from repro_torch.core.union_sampler import SetUnionSampler

STAT_FIELDS = ("iterations", "candidate_draws", "cover_rejects",
               "residual_rejects", "pred_rejects", "dropped_slots",
               "samples_emitted")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _union_equals_reference(name, fused_rounds):
    wl, est = union_setup(name)
    ref = RefSetUnionSampler(wl.cat, wl.joins, est.cover, seed=3,
                             backend="jax", round_batch=512,
                             fused_rounds="device", plan="static")
    cat, specs, cover = to_port(wl.joins, est.cover)
    port = SetUnionSampler(cat, specs, cover, seed=3, device="cpu",
                           round_batch=512, uniforms=JaxReplay(3),
                           fused_rounds=fused_rounds)
    assert port.engine.fused_rounds == fused_rounds
    assert port.engine.piece_batches == ref._engine.piece_batches
    for n in (1100, 2048, 1500):          # one capacity class on the JAX side
        a, b = ref.sample(n), port.sample(n)
        assert len(b) == n
        assert np.array_equal(sample_multiset(a), sample_multiset(b))
        for f in STAT_FIELDS:
            assert getattr(a.stats, f) == getattr(b.stats, f), f
        assert np.array_equal(ref._engine.piece_stats, port.engine.piece_stats)
        assert ref._engine.last_rounds == port.engine.last_rounds
        # one sync per chunk of rounds plus the one fetch; the host loop's
        # chunks are single rounds
        eng = port.engine
        assert eng.last_host_syncs == eng.last_chunks + 1
        assert (eng.last_chunks == eng.last_rounds if fused_rounds == "host"
                else eng.last_chunks <= eng.last_rounds)
        # fingerprints of the host SampleSet agree with its rows
        order = np.lexsort(b.matrix().T[::-1])
        ref_order = np.lexsort(a.matrix().T[::-1])
        assert np.array_equal(a.fingerprint[ref_order], b.fingerprint[order])
    if name == "uq1":
        assert a.stats.dropped_slots > 0
    else:
        assert a.stats.cover_rejects > 0


@pytest.mark.parametrize("name", ["uq1", "uq3", "uq4"])
def test_union_equals_reference_under_replayed_uniforms(name):
    """The default device loop (chunks of rounds between syncs)."""
    _union_equals_reference(name, "device")


@pytest.mark.parametrize("name", ["uq1", "uq3", "uq4"])
def test_union_host_loop_equals_reference_under_replayed_uniforms(name):
    """``fused_rounds="host"``: one sync per round."""
    _union_equals_reference(name, "host")


def test_philox_stream_uniform_over_exact_union():
    wl = uq1(scale=0.05, overlap=0.4, seed=0)
    est = estimate_union(warmup(wl.cat, wl.joins, method="exact").oracle)
    U = exact_union_size(wl.cat, wl.joins)
    cat, specs, cover = to_port(wl.joins, est.cover)
    s = SetUnionSampler(cat, specs, cover, seed=7, device="cpu",
                        round_batch=1024)
    N = 120 * U
    ss = s.sample(N)
    assert len(ss) == N and ss.rows[s.attrs[0]].dtype == np.int64
    m = ss.matrix()
    uni, counts = np.unique(m.view([("", m.dtype)] * m.shape[1]).ravel(),
                            return_counts=True)
    assert uni.shape[0] <= U
    exp = N / U
    chi2 = float(((counts - exp) ** 2 / exp).sum()) + (U - uni.shape[0]) * exp
    p = 1 - sps.chi2.cdf(chi2, df=U - 1)
    assert p > 1e-3, f"port not uniform over the union (p={p})"
    # every sample is a member of its home piece and of no earlier piece
    mm = s.prober.membership_matrix(ss.rows, s.order)
    first = np.argmax(mm, axis=1)
    assert mm.any(axis=1).all() and np.array_equal(first, ss.home)


def test_serve_cli_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "samples",
         "--device", "cpu", "--scale", "0.05", "--requests", "2",
         "--samples", "256"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "served 2 requests x 256 samples (512 total)" in proc.stdout
