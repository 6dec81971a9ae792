"""The adaptive round planner in the port against the reference.

* ``budget_for`` and ``ema_update`` are bit-identical across numpy, jnp and
  torch (int32 in, int32 out) on random inputs and on the edge values:
  ``need`` at ``NEED_CLAMP`` and above, ``ema`` at and below ``EMA_FLOOR``,
  ``drawn`` 0, and ``rate < ema`` (an arithmetic right shift of a negative).
* ``seed_rates``, ``alloc_batches``, ``ema_shifts`` and ``adaptive_slot``
  equal the reference's on UQ1, UQ2 (both modes) and UQ4 covers; the
  ``PlanCache`` fit and suggestion equal the reference's on the same
  observations, and ``round_batch=None`` consults the port's cache.
* ``plan="adaptive"`` on UQ1, UQ4 and UQ2 (both modes) equals
  ``SetUnionSampler(backend="jax", fused_rounds="device", plan="adaptive")``
  under replayed uniforms over three calls, and the port's own stream is
  uniform over UQ1's exact union (chi-square).
* The serve CLI runs UQ2 with ``--plan adaptive`` on the CPU.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats as sps

from test_torch_support import JaxReplay, sample_multiset, to_port

from repro.core import planner as ref_planner
from repro.core.framework import estimate_union, warmup
from repro.core.overlap import exact_union_size
from repro.core.union_sampler import SetUnionSampler as RefSetUnionSampler
from repro.data.workloads import uq1, uq2, uq4

from repro_torch.core import planner
from repro_torch.core.union_sampler import SetUnionSampler

STAT_FIELDS = ("iterations", "candidate_draws", "cover_rejects",
               "residual_rejects", "pred_rejects", "dropped_slots",
               "samples_emitted")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _budget_three_ways(need, bank, ema, bmax, dw):
    a = ref_planner.budget_for(need, bank, ema, bmax, dw, np)
    b = ref_planner.budget_for(jnp.asarray(need), jnp.asarray(bank),
                               jnp.asarray(ema), jnp.asarray(bmax), dw, jnp)
    c = planner.budget_for(torch.from_numpy(need), torch.from_numpy(bank),
                           torch.from_numpy(ema), torch.from_numpy(bmax), dw,
                           planner.TORCH_XP)
    d = planner.budget_for(need, bank, ema, bmax, dw, np)
    assert c.dtype == torch.int32 and d.dtype == np.int32
    for x in (b, c.numpy(), d):
        assert np.array_equal(np.asarray(a, np.int32), np.asarray(x))
    return d


def _ema_three_ways(e0, drawn, counts, shifts):
    a = ref_planner.ema_update(e0, drawn, counts, shifts, np)
    b = ref_planner.ema_update(jnp.asarray(e0), jnp.asarray(drawn),
                               jnp.asarray(counts), jnp.asarray(shifts), jnp)
    c = planner.ema_update(torch.from_numpy(e0), torch.from_numpy(drawn),
                           torch.from_numpy(counts), torch.from_numpy(shifts),
                           planner.TORCH_XP)
    d = planner.ema_update(e0, drawn, counts, shifts, np)
    assert c.dtype == torch.int32 and d.dtype == np.int32
    for x in (b, c.numpy(), d):
        assert np.array_equal(np.asarray(a, np.int32), np.asarray(x))
    return d


def test_budget_and_ema_bit_identical_numpy_jnp_torch():
    rng = np.random.default_rng(0)
    for _ in range(15):
        nj = int(rng.integers(1, 7))
        need = rng.integers(0, 1 << 15, nj).astype(np.int32)
        bank = rng.integers(0, 4096, nj).astype(np.int32)
        ema = rng.integers(0, planner.EMA_ONE + 1, nj).astype(np.int32)
        bmax = rng.integers(64, 8192, nj).astype(np.int32)
        _budget_three_ways(need, bank, ema, bmax, int(rng.integers(1, 257)))
        drawn = rng.integers(0, 1 << 20, nj).astype(np.int32)
        counts = np.stack([rng.integers(0, d + 1, 4) for d in drawn]
                          ).astype(np.int32)
        shifts = planner.ema_shifts(drawn.tolist())
        assert np.array_equal(shifts, ref_planner.ema_shifts(drawn.tolist()))
        e0 = rng.integers(0, planner.EMA_ONE + 1, (nj, 4)).astype(np.int32)
        _ema_three_ways(e0, drawn, counts, shifts)


def test_budget_and_ema_edge_values():
    C, F, ONE = planner.NEED_CLAMP, planner.EMA_FLOOR, planner.EMA_ONE
    need = np.asarray([C, C + 1, 1 << 20, 0, 5, 1, C, 300], np.int32)
    bank = np.asarray([0, 0, 0, 9, 5, 0, 256, 400], np.int32)
    ema = np.asarray([F, F - 1, 0, ONE, F, ONE, ONE, F + 1], np.int32)
    bmax = np.asarray([1 << 30, 8192, 64, 64, 64, 64, 1 << 30, 4096],
                      np.int32)
    b = _budget_three_ways(need, bank, ema, bmax, 256)
    # the clamp holds need * EMA_ONE inside int32; no work, no budget
    assert b[0] > 0 and b[1] == 8192 and b[4] == 0
    assert b[5] == planner.BUDGET_FLOOR and b[2] == 64
    drawn = np.asarray([0, 8192, 1 << 20, 1, 256, 300], np.int32)
    counts = np.asarray([[0, 0, 0, 0], [0, 8192, 0, 0],
                         [1 << 20, 1 << 20, 0, 0], [0, 1, 0, 1],
                         [3, 256, 0, 0], [300, 300, 0, 0]], np.int32)
    e0 = np.asarray([[ONE, ONE, 0, 0], [ONE, ONE, ONE, ONE],
                     [0, 0, 0, 0], [ONE, ONE, 0, 0], [F, ONE, 0, 0],
                     [ONE, ONE, 0, 0]], np.int32)
    shifts = planner.ema_shifts(drawn.tolist())
    u = _ema_three_ways(e0, drawn, counts, shifts)
    assert np.array_equal(u[0], e0[0])               # drawn 0 keeps the EMA
    assert u[1, 0] < e0[1, 0]                         # rate < ema: shifts down
    assert u[3, 0] == ONE - (ONE >> 3) and u[3, 3] == ONE >> 3


def _covers():
    out = {"uq1": uq1(scale=0.05, overlap=0.4, seed=0),
           "uq2_pushdown": uq2(scale=0.02, seed=0, pred_mode="pushdown"),
           "uq2_rejection": uq2(scale=0.02, seed=0, pred_mode="rejection"),
           "uq4": uq4(scale=0.05, seed=0)}
    return {k: (wl, estimate_union(warmup(wl.cat, wl.joins,
                                          method="histogram").oracle).cover)
            for k, wl in out.items()}


def test_seed_rates_and_widths_equal_reference():
    for name, (wl, cover) in _covers().items():
        cat, specs, pcover = to_port(wl.joins, cover)
        ref_specs = {j.name: j for j in wl.joins}
        pt_specs = {j.name: j for j in specs}
        seed = planner.seed_rates(pcover, pt_specs)
        assert np.array_equal(seed, ref_planner.seed_rates(cover, ref_specs))
        probs = np.asarray(pcover.selection_probs())
        for rb in (512, 4096, 8192):
            slot = planner.adaptive_slot(rb)
            assert slot == ref_planner.adaptive_slot(rb)
            base = [256] * len(probs)
            w = planner.alloc_batches(base, probs, seed[:, 0], slot)
            assert w == ref_planner.alloc_batches(base, probs, seed[:, 0],
                                                  slot), name
            assert np.array_equal(planner.ema_shifts(w),
                                  ref_planner.ema_shifts(w))
        if name == "uq2_rejection":
            assert (seed[:, 3] > 0).all()    # predicate-reject seed column


def test_plan_cache_equals_reference():
    obs = [(512, 900, 12, 0.031, 4096), (512, 900, 10, 0.024, 4096),
           (2048, 3600, 3, 0.02, 4096), (8192, 14000, 1, 0.05, 8192)]
    for n_obs in (1, 2, 4):
        a, b = planner.PlanCache(), ref_planner.PlanCache()
        for o in obs[:n_obs]:
            a.observe("k", *o)
            b.observe("k", *o)
        assert a.fit("k") == b.fit("k")
        assert dataclasses_tuple(a.suggest("k")) == \
            dataclasses_tuple(b.suggest("k"))
    assert planner.PlanCache().suggest("missing") is None


def dataclasses_tuple(p):
    return (p.round_batch, p.surplus_cap, p.drain_window)


def test_round_batch_none_consults_plan_cache():
    wl = uq1(scale=0.05, overlap=0.4, seed=0)
    est = estimate_union(warmup(wl.cat, wl.joins, method="histogram").oracle)
    cat, specs, cover = to_port(wl.joins, est.cover)
    planner.PLAN_CACHE.reset()
    cold = SetUnionSampler(cat, specs, cover, device="cpu", round_batch=None)
    assert cold.autotuned_plan is None and cold.engine.round_batch == 4096
    cold.sample(512)                       # a timed call feeds the cache
    warm = SetUnionSampler(cat, specs, cover, device="cpu", round_batch=None)
    assert warm.autotuned_plan is not None
    assert warm.engine.round_batch == warm.autotuned_plan.round_batch
    assert warm.engine.surplus_cap == warm.autotuned_plan.surplus_cap
    planner.PLAN_CACHE.reset()


def _setup(name):
    if name == "uq1":
        wl = uq1(scale=0.05, overlap=0.4, seed=0)
        return wl, estimate_union(warmup(wl.cat, wl.joins,
                                         method="histogram").oracle)
    if name.startswith("uq2_"):
        # the exact warm-up gives all three flavours mass at this scale
        wl = uq2(scale=0.02, seed=0, pred_mode=name[4:])
        return wl, estimate_union(warmup(wl.cat, wl.joins,
                                         method="exact").oracle)
    wl = uq4(scale=0.05, seed=0)
    return wl, estimate_union(warmup(wl.cat, wl.joins, method="exact").oracle,
                              order=["UQ4_CHAIN", "UQ4_CYC"])


@pytest.mark.parametrize("name", ["uq1", "uq4", "uq2_pushdown",
                                  "uq2_rejection"])
def test_adaptive_equals_reference_under_replayed_uniforms(name):
    wl, est = _setup(name)
    ref = RefSetUnionSampler(wl.cat, wl.joins, est.cover, seed=3,
                             backend="jax", round_batch=512,
                             fused_rounds="device", plan="adaptive")
    cat, specs, cover = to_port(wl.joins, est.cover)
    port = SetUnionSampler(cat, specs, cover, seed=3, device="cpu",
                           round_batch=512, uniforms=JaxReplay(3),
                           plan="adaptive")
    eng = port.engine
    assert eng.piece_batches == ref._engine.piece_batches
    assert eng._slot_width == ref._engine._slot_width > 512
    for n in (1100, 2048, 1500):
        a, b = ref.sample(n), port.sample(n)
        assert np.array_equal(sample_multiset(a), sample_multiset(b))
        for f in STAT_FIELDS:
            assert getattr(a.stats, f) == getattr(b.stats, f), f
        assert np.array_equal(ref._engine.piece_stats, eng.piece_stats)
        assert ref._engine.last_rounds == eng.last_rounds
        # the carried EMAs are the reference's, bit for bit
        assert np.array_equal(np.asarray(ref._engine._dev_state["ema"]),
                              eng._state.ema.numpy())
    # budgets, not widths, are counted as draws
    assert b.stats.candidate_draws < eng.total_rounds * sum(eng.piece_batches)
    # rejection mode feeds the EMAs' predicate column; pushdown rejects none
    assert (b.stats.pred_rejects > 0) == (name == "uq2_rejection")
    assert (eng._state.ema[:, 3] > 0).any() == (name == "uq2_rejection")


def test_adaptive_stream_uniform_over_exact_union():
    wl = uq1(scale=0.05, overlap=0.4, seed=0)
    est = estimate_union(warmup(wl.cat, wl.joins, method="exact").oracle)
    U = exact_union_size(wl.cat, wl.joins)
    cat, specs, cover = to_port(wl.joins, est.cover)
    s = SetUnionSampler(cat, specs, cover, seed=7, device="cpu",
                        round_batch=1024, plan="adaptive")
    N = 120 * U
    ss = s.sample(N)
    m = ss.matrix()
    uni, counts = np.unique(m.view([("", m.dtype)] * m.shape[1]).ravel(),
                            return_counts=True)
    assert uni.shape[0] <= U
    exp = N / U
    chi2 = float(((counts - exp) ** 2 / exp).sum()) + (U - uni.shape[0]) * exp
    p = 1 - sps.chi2.cdf(chi2, df=U - 1)
    assert p > 1e-3, f"adaptive plan not uniform over the union (p={p})"
    mm = s.prober.membership_matrix(ss.rows, s.order)
    assert np.array_equal(np.argmax(mm, axis=1), ss.home)


def test_serve_cli_uq2_adaptive_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "samples",
         "--device", "cpu", "--scale", "0.05", "--requests", "2",
         "--samples", "256", "--workload", "UQ2", "--plan", "adaptive"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "served 2 requests x 256 samples (512 total)" in proc.stdout
    assert "workload=UQ2, plan=adaptive" in proc.stdout
