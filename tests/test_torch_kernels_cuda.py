"""The CUDA kernels against their plain versions, on the card.

The cases come from ``repro_torch.kernels.cases``, which the CPU tests
(``test_torch_kernels.py``, ``test_torch_ops.py``) and ``chip_smoke.py``
share.  Imports neither ``jax`` nor ``repro``, so it runs on a machine that
has only the port::

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda \\
        tests/test_torch_kernels_cuda.py

The UQ2 cases build the §8.3 predicate workload in both modes and hold
every flavour's tree draws through the kernels equal to its draws through
the plain versions on the same uniforms; the walk case holds every UQ1
wander-join walk through ``probe_pick`` equal to the plain walk.  The
device-loop cases capture the union engine's round as a CUDA graph
(``fused_rounds="device"``) and hold it bit-equal to the host loop, on UQ1
under both plans and on UQ2 rejection mode.  ``member_lookup`` runs every
case of ``cases.MEMBER_CASES`` against its plain version, and the device
loop with it equals the loop with the plain version forced, on UQ4's
cyclic union and UQ2's predicates.  Decode attention runs every
case of ``cases.ATTENTION_CASES``, the attention shapes of every config
among them; a shape the kernel does not take must raise and launch
nothing; and nine ``decode_step``s of the smoke configs of every family
through the kernel must agree with the same steps through the plain
version (``cases.lm_logits_agreement``; mamba2 launches none).

Without a card every test here skips.
"""

import pytest
import torch

from repro_torch.kernels import attention, member, probe, segdegree
from repro_torch.kernels.cases import (ATTENTION_CASES, MEMBER_CASES,
                                       MEMBER_LAUNCHES, PROBE_CARD_CASES,
                                       PROBE_CASES, SEGDEGREE_CARD_CASES,
                                       SEGDEGREE_CASES,
                                       attention_case, attention_tol,
                                       key_dtypes, lm_logits_agreement,
                                       member_case, member_plan, probe_case,
                                       probe_uniforms, segdegree_card_case)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", PROBE_CASES + PROBE_CARD_CASES)
def test_kernels_on_card_equal_plain(name):
    _need_card()
    keys, qs = probe_case(name)
    u = torch.as_tensor(probe_uniforms(name, qs.shape[0]), device="cuda")
    for dt in key_dtypes(keys, qs):
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


@pytest.mark.cuda
@pytest.mark.parametrize("name", MEMBER_CASES)
def test_member_lookup_on_card_equals_plain(name):
    """Bit-equal verdicts and lookup counts, one launch a call (two past
    one launch's capacities); ``contains`` of each piece on the card
    equals the plain one."""
    _need_card()
    plan, rows, acc, preds = member_plan(member_case(name), "cuda")
    before = probe.launch_counts["member_lookup"]
    out, lookups = member.member_lookup(plan, rows, acc, preds)
    launched = probe.launch_counts["member_lookup"] - before
    out_p, lookups_p = member.member_lookup_plain(plan, rows, acc, preds)
    torch.cuda.synchronize()
    assert launched == len(MEMBER_LAUNCHES.get(name, [(0, 0)]))
    assert torch.equal(out, out_p)
    assert int(lookups) == int(lookups_p)
    for q, piece in enumerate(plan.pieces):
        one = member.MemberPlan([piece])
        got = member.contains(one, rows, preds[q])
        want = member.contains_plain(piece, rows, preds[q])
        assert torch.equal(got, want), q


def _segdegree_kernels(n):
    """Kernels one call launches: one (none for n = 0)."""
    return 1 if n else 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", SEGDEGREE_CASES + SEGDEGREE_CARD_CASES)
def test_segdegree_on_card_equals_plain(name):
    _need_card()
    dev = torch.device("cuda", 0)
    for dt in (torch.int64, torch.int32):
        # the boundary cases follow the CTA ranges of a call of this width
        width = 4 if dt == torch.int32 else 8
        base, off = segdegree_card_case(
            name, lambda n: segdegree.cta_keys(n, width, dev))
        if dt not in key_dtypes(base):
            continue
        k = torch.as_tensor(base, device="cuda").to(dt)[off:]
        before = probe.launch_counts["segdegree"]
        got = segdegree.segdegree(k)
        assert got == segdegree.segdegree_plain(k), (name, dt)
        assert (probe.launch_counts["segdegree"]
                == before + _segdegree_kernels(k.numel()))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTENTION_CASES)
def test_decode_attention_on_card_equals_plain(case):
    _need_card()
    c = attention_case(case)
    dt, cap, win = c["dtype"], c["softcap"], c["window"]
    t = [torch.as_tensor(c[x], device="cuda").to(dt) for x in "qkv"]
    lt = torch.as_tensor(c["lens"], device="cuda")
    before = probe.launch_counts["decode_attention"]
    out = attention.decode_attention(*t, lt, softcap=cap, window=win)
    # the plain version in fp32 from the same (possibly bf16) inputs
    want = attention.decode_attention_plain(*(x.float() for x in t), lt,
                                            softcap=cap, window=win)
    torch.cuda.synchronize()
    # the plan and the attention kernel
    assert probe.launch_counts["decode_attention"] == before + 2
    assert out.dtype == dt and out.shape == want.shape
    tol = attention_tol(dt)
    torch.testing.assert_close(out.float(), want, **tol)
    if case == "length_0":
        assert not out[0].any()
    elif case == "skewed_lengths":
        assert not out[1].any()
    elif case == "all_zero_lengths":
        assert not out.any()
    elif case.startswith("head_mapping"):
        # query head h reads KV head h // G, whose values are all h // G + 1
        heads = torch.as_tensor(c["heads"], dtype=torch.float32,
                                device="cuda")
        torch.testing.assert_close(out.float(), heads[None, :, None].expand(
            out.shape), rtol=1e-6, atol=0)
    elif case.startswith("softcap_range"):
        # control: the same kernel without the softcap must fail the limit
        nocap = attention.decode_attention(*t, lt, softcap=0.0, window=win)
        assert not torch.allclose(nocap.float(), want, **tol)


@pytest.mark.cuda
def test_decode_attention_refuses_other_shapes_on_card():
    """A shape the kernel does not take raises on a CUDA tensor and
    launches nothing: no path gives way to the plain version."""
    _need_card()
    for H, KVH, D in ((4, 2, 32), (49, 1, 64), (4, 2, 96), (100, 2, 128)):
        q = torch.zeros((1, H, D), device="cuda")
        k = torch.zeros((1, 8, KVH, D), device="cuda")
        before = probe.launch_counts["decode_attention"]
        with pytest.raises(ValueError, match="the kernel takes"):
            attention.decode_attention(q, k, k, torch.tensor([8],
                                                             device="cuda"))
        assert probe.launch_counts["decode_attention"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["minitron-8b", "granite-20b",
                                  "mistral-large-123b", "gemma2-9b",
                                  "phi3.5-moe-42b-a6.6b", "arctic-480b",
                                  "mamba2-780m", "zamba2-7b",
                                  "whisper-medium", "paligemma-3b"])
def test_decode_step_on_card_equals_plain(monkeypatch, arch):
    """Nine decode steps of a smoke config (bf16) through B4 and through
    ``decode_attention_plain``, on the same parameters and tokens: two
    launches per decode attention and step (``serve.attention_calls_per_
    step``: one per attention layer, one per zamba2 group, two per encdec
    layer, none for mamba2), logits within ``cases.LM_PATH_*``.  Row 1
    starts at length 30, past gemma2's smoke window 32 by step 3, so its
    local ring wraps."""
    _need_card()
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import serve, transformer
    cfg = get_smoke_config(arch)
    params = transformer.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(1)
    B, T, max_len = 3, 9, 48
    toks = torch.randint(4, cfg.vocab, (B, T), generator=g, device="cuda")
    start = torch.tensor([0, 30, 5], device="cuda")

    def plain(q, k, v, lengths, softcap=0.0, window=0):
        return attention.decode_attention_plain(q, k, v, lengths,
                                                softcap=softcap, window=window)
    runs = {}
    for mode in ("kernel", "plain"):
        if mode == "plain":
            monkeypatch.setattr(attention, "decode_attention", plain)
        cache = serve.init_cache(cfg, B, max_len, device="cuda")
        before = probe.launch_counts["decode_attention"]
        logits = []
        for t in range(T):
            cache, lg = serve.decode_step(params, cfg, cache, toks[:, t:t + 1],
                                          start + t)
            logits.append(lg)
        torch.cuda.synchronize()
        launched = probe.launch_counts["decode_attention"] - before
        calls = serve.attention_calls_per_step(cfg)
        assert launched == (2 * T * calls if mode == "kernel" else 0)
        runs[mode] = torch.stack(logits)
    assert bool(torch.isfinite(runs["kernel"]).all())
    lm_logits_agreement(runs["kernel"], runs["plain"], arch)


@pytest.mark.cuda
@pytest.mark.parametrize("pred_mode", ["pushdown", "rejection"])
def test_uq2_draws_on_card_equal_plain(pred_mode):
    _need_card()
    from repro_torch.core.backends.torch_backend import TorchBackend
    from repro_torch.data.workloads import uq2
    wl = uq2(scale=1.0, seed=0, pred_mode=pred_mode)
    be = TorchBackend(wl.cat, wl.joins, device="cuda")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    for j in wl.joins:
        tree = be.trees[j.name]
        assert tree.masked == (pred_mode == "pushdown")
        before = dict(probe.launch_counts)
        u = torch.rand((tree.n_streams, 4096), generator=g, device="cuda")
        k_rows, k_acc, k_ok = tree.draw(u)
        p_rows, p_acc, p_ok = tree.draw(u, plain=True)
        torch.cuda.synchronize()
        for a in tree.attrs:
            assert torch.equal(k_rows[a], p_rows[a]), (j.name, a)
        assert torch.equal(k_acc, p_acc) and torch.equal(k_ok, p_ok)
        launched = {k: probe.launch_counts[k] - before[k]
                    for k in ("sorted_probe", "probe_pick")}
        weighted = sum(not c.uniform for c in tree.node_cfgs)
        assert launched["sorted_probe"] == weighted, j.name
        assert launched["probe_pick"] == len(tree.node_cfgs) - weighted
        if pred_mode == "rejection":
            assert launched["probe_pick"] > 0
        # pushdown: every accepted draw lies in the flavour's filtered join
        keep = torch.ones_like(k_acc)
        for p in j.pushed_preds:
            keep &= torch.as_tensor(
                p.mask({a: c.cpu().numpy() for a, c in k_rows.items()}),
                device="cuda")
        assert bool(keep[k_acc].all())


@pytest.mark.cuda
def test_uq1_walks_on_card_equal_plain():
    """Every UQ1 wander-join walk hop runs ``probe_pick``: kernel walks equal
    plain walks on the same root positions and uniforms (rows, float32
    probabilities, ``ok``), and the hops launch one kernel each."""
    _need_card()
    from repro_torch.core.backends.torch_backend import PhiloxUniforms
    from repro_torch.core.estimators.torch_estimator import TorchWalkJoin
    from repro_torch.data.workloads import uq1
    wl = uq1(scale=0.05, overlap=0.4, seed=0)
    stream = PhiloxUniforms(0, "cuda")
    for j in wl.joins:
        walker = TorchWalkJoin(wl.cat, j, device="cuda")
        r_pos, u = stream.walk(walker.n_root, walker.n_hops, 512)
        before = probe.launch_counts["probe_pick"]
        k_rows, k_prob, k_ok = walker.draw(r_pos, u)
        launched = probe.launch_counts["probe_pick"] - before
        p_rows, p_prob, p_ok = walker.draw(r_pos, u, plain=True)
        torch.cuda.synchronize()
        assert launched == walker.n_hops, j.name
        for a in walker.attrs:
            assert torch.equal(k_rows[a], p_rows[a]), (j.name, a)
        assert torch.equal(k_prob, p_prob) and torch.equal(k_ok, p_ok)


def _device_host_pair(wl, cover, **kw):
    from repro_torch.core.union_sampler import SetUnionSampler
    return [SetUnionSampler(wl.cat, wl.joins, cover, seed=11, device="cuda",
                            round_batch=1024, fused_rounds=mode, **kw)
            for mode in ("device", "host")]


def _assert_same_calls(dev, host, ns):
    for n in ns:
        a, b = dev.sample(n), host.sample(n)
        for attr in a.attrs:
            assert (a.rows[attr] == b.rows[attr]).all()
        assert (a.home == b.home).all()
        assert dev.stats.as_dict() == host.stats.as_dict()
        assert (dev.engine.piece_stats == host.engine.piece_stats).all()
        assert dev.engine.last_rounds == host.engine.last_rounds
        assert dev.engine.last_host_syncs == dev.engine.last_chunks + 1
    st_d, st_h = dev.engine._state, host.engine._state
    for f in ("owed", "dead", "streak", "head", "count"):
        assert torch.equal(getattr(st_d, f), getattr(st_h, f)), f
    assert torch.equal(st_d.bank[:, :-1], st_h.bank[:, :-1])
    assert (dev.engine.uniforms.generator.get_offset()
            == host.engine.uniforms.generator.get_offset())


@pytest.mark.cuda
@pytest.mark.parametrize("plan,chunk", [("static", None), ("static", 16),
                                        ("adaptive", None)])
def test_device_loop_capture_equals_host_loop_on_card(plan, chunk):
    """The round captured as a CUDA graph per capacity class and replayed
    in chunks equals the host loop bit for bit over calls that cross
    classes, the rewound Philox offset included; the profiler sees each
    probe's kernels recorded in one round once per round replayed."""
    _need_card()
    from repro_torch.core.framework import estimate_union, warmup
    from repro_torch.data.workloads import uq1
    wl = uq1(scale=1.0, seed=0)
    cover = estimate_union(warmup(wl.cat, wl.joins,
                                  method="histogram").oracle).cover
    dev, host = _device_host_pair(wl, cover, plan=plan)
    dev.engine.chunk_rounds = chunk
    _assert_same_calls(dev, host, (700, 1500, 333))
    assert set(dev.engine._buffers) == {1024, 2048} \
        == set(dev.engine.capture_seconds)
    cb = dev.engine._buffers[2048]
    assert cb.graph is not None
    assert cb.replay_launches["sorted_probe"] > 0
    assert cb.replay_launches["probe_pick"] > 0
    # the kernels the card ran in a call of replays: the profiler's events
    # are the launches recorded per round × the rounds replayed
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dev.sample(1500)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    eng = dev.engine
    replays = eng.last_rounds + eng.last_wasted_rounds
    for k in ("sorted_probe", "probe_pick"):
        seen = sum(1 for name in names if f"{k}_kernel" in name)
        assert seen == cb.replay_launches[k] * replays, k


@pytest.mark.cuda
@pytest.mark.parametrize("plan", ["static", "adaptive"])
def test_pipelined_calls_on_card_equal_sequential_calls(plan):
    """Each call launched (its first chunk of graph replays queued) before
    the one before it is drained, as the serve tier does: the rows, stats,
    carry and Philox offset of the same calls made one after the other,
    every drain overlapped, and no served column aliasing the pinned copy
    that a later call reuses (all compared after the last call)."""
    _need_card()
    from repro_torch.core.framework import estimate_union, warmup
    from repro_torch.core.union_sampler import SetUnionSampler
    from repro_torch.data.workloads import uq1
    wl = uq1(scale=1.0, seed=0)
    cover = estimate_union(warmup(wl.cat, wl.joins,
                                  method="histogram").oracle).cover
    pipe, seq = [SetUnionSampler(wl.cat, wl.joins, cover, seed=11,
                                 device="cuda", round_batch=1024, plan=plan)
                 for _ in range(2)]
    sizes = (700, 1500, 333, 2048, 900, 2048)
    want = [seq.sample(n) for n in sizes]
    got = []
    pending = pipe.sample_async(sizes[0])
    for n in sizes[1:]:
        nxt = pipe.sample_async(n)
        got.append(pending.result())
        pending = nxt
    got.append(pending.result())
    for a, b in zip(got, want):
        for attr in a.attrs:
            assert (a.rows[attr] == b.rows[attr]).all()
        assert (a.home == b.home).all()
        assert (a.fingerprint == b.fingerprint).all()
    pe, se = pipe.engine, seq.engine
    assert pipe.stats.as_dict() == seq.stats.as_dict()
    assert (pe.piece_stats == se.piece_stats).all()
    for f in ("owed", "dead", "streak", "head", "count"):
        assert torch.equal(getattr(pe._state, f), getattr(se._state, f)), f
    assert torch.equal(pe._state.bank[:, :-1], se._state.bank[:, :-1])
    assert (pe.uniforms.generator.get_offset()
            == se.uniforms.generator.get_offset())
    assert (pe.host_syncs, pe.total_rounds) == (se.host_syncs,
                                                se.total_rounds)
    assert pe.overlapped_drains == len(sizes) - 1


@pytest.mark.cuda
def test_device_loop_capture_with_predicate_masks_on_card():
    """UQ2 rejection mode: the in-round predicate masks (sorted-set
    lookups for ``in``) are captured too."""
    _need_card()
    from repro_torch.core.framework import estimate_union, warmup
    from repro_torch.data.workloads import uq2
    wl = uq2(scale=1.0, seed=0, pred_mode="rejection")
    cover = estimate_union(warmup(wl.cat, wl.joins,
                                  method="exact").oracle).cover
    dev, host = _device_host_pair(wl, cover)
    _assert_same_calls(dev, host, (2048, 999))
    assert dev.stats.pred_rejects > 0


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window,cap,prefix", [
    (True, 0, 0.0, 0), (True, 24, 30.0, 0), (True, 0, 0.0, 16),
    (True, 20, 0.0, 8), (False, 0, 0.0, 0)])
def test_flash_attention_cv_grads_on_card_equal_cpu(causal, window, cap,
                                                    prefix):
    """The training attention's recompute backward on the card against the
    same function on the CPU (float32, full-precision products: the
    gradient limit of ``test_torch_train.py``, rtol 1e-4 and atol 1e-5 ×
    max|g|)."""
    _need_card()
    import numpy as np
    from repro_torch.models import layers
    rng = np.random.default_rng(5)
    B, S, H, KV, D = 2, 64, 6, 2, 16
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D),
                        (B, S, H, D))]
    grads = {}
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dev in ("cpu", "cuda"):
            q, k, v = (torch.tensor(a, device=dev, requires_grad=True)
                       for a in arrays[:3])
            o = layers.flash_attention_cv(q, k, v, causal, window, cap, 16,
                                          32, prefix)
            (o * torch.as_tensor(arrays[3], device=dev)).sum().backward()
            grads[dev] = [t.cpu().numpy() for t in (o.detach(), q.grad,
                                                    k.grad, v.grad)]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for got, want in zip(grads["cuda"], grads["cpu"]):
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["uq4", "uq2_rejection", "uq1_15"])
def test_device_loop_with_member_lookup_equals_plain_route(workload,
                                                           monkeypatch):
    """The captured round with ``member_lookup`` and the same round with
    the plain version forced: the same samples, homes, stats (member
    lookups included), per-piece counters, carry and Philox offset, on a
    cyclic union, on UQ2's rejection predicates (masks passed in) and on
    a UQ1 of 15 joins, whose last two probing joins (65 and 70 relations)
    pass one launch's capacities and take two launches each."""
    _need_card()
    from repro_torch.core.framework import estimate_union, warmup
    from repro_torch.core.union_sampler import SetUnionSampler
    from repro_torch.data.workloads import uq1, uq2, uq4
    wl = {"uq4": lambda: uq4(scale=0.5, seed=0),
          "uq2_rejection": lambda: uq2(scale=1.0, seed=0,
                                       pred_mode="rejection"),
          "uq1_15": lambda: uq1(scale=0.05, seed=0, n_joins=15)}[workload]()
    # the exact warm-up's intersection terms grow as 2^joins
    method = "histogram" if workload == "uq1_15" else "exact"
    cover = estimate_union(warmup(wl.cat, wl.joins,
                                  method=method).oracle).cover

    def run():
        s = SetUnionSampler(wl.cat, wl.joins, cover, seed=13, device="cuda",
                            round_batch=1024)
        return s, [s.sample(n) for n in (2048, 999, 1500)]

    kern, got = run()
    cb = kern.engine._buffers[2048]
    runs = [len(kern.engine._member_plan(j).launches)
            for j in range(1, len(wl.joins))]
    assert runs == ([1] * 12 + [2, 2] if workload == "uq1_15"
                    else [1] * (len(wl.joins) - 1))
    assert cb.replay_launches["member_lookup"] == sum(runs)
    monkeypatch.setattr(member, "member_lookup", member.member_lookup_plain)
    plain, want = run()
    assert plain.engine._buffers[2048].replay_launches["member_lookup"] == 0
    for a, b in zip(got, want):
        for attr in a.attrs:
            assert (a.rows[attr] == b.rows[attr]).all()
        assert (a.home == b.home).all()
    assert kern.stats.as_dict() == plain.stats.as_dict()
    assert kern.stats.member_lookups > 0
    ke, pe = kern.engine, plain.engine
    assert (ke.piece_stats == pe.piece_stats).all()
    for f in ("owed", "dead", "streak", "head", "count"):
        assert torch.equal(getattr(ke._state, f), getattr(pe._state, f)), f
    assert torch.equal(ke._state.bank[:, :-1], pe._state.bank[:, :-1])
    assert (ke.uniforms.generator.get_offset()
            == pe.uniforms.generator.get_offset())
