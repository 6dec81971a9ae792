#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA card::

    python3 chip_smoke.py              # UQ1 at scale 100 (≈ TPC-H SF 1)
    python3 chip_smoke.py --scale 1 --uq4-scale 1    # a quick, small run

Phases, in order (each raises on failure, so any failure exits non-zero):

1. device and build — the card's name and power limit; the CUDA kernels of
   ``src/repro_torch/kernels/csrc`` built with nvcc (time and ptxas report);
2. kernels — ``sorted_probe`` and ``probe_pick`` against their plain PyTorch
   versions on the card, at the main path's shapes (UQ1's indexes with one
   piece batch of queries) and on edge sweeps with the shared pick
   uniforms (``cases.probe_uniforms``), exact equality; device times of
   kernel, plain version and ``torch.searchsorted``, and the bound; for
   both their group width G and levels (dependent loads) against a binary
   search's, bound shares, launches per call and the ptxas report of both
   key widths; for ``sorted_probe`` also its ratios to the library at the
   orders and lineitem indexes; for ``probe_pick`` the time of the port's
   two-step route (``sorted_probe`` + ``pick_from_range``) on the same
   inputs and, from phase 6, its time at UQ4's residual index;
3. draw parity — every UQ1 ``TorchTreeJoin`` draws identically through the
   kernels and through the plain versions on the same uniforms;
4. main path — ``SetUnionSampler(backend="torch", device="cuda")`` on UQ1
   served through ``SampleService`` (one warm-up request, then 16 × 4096),
   with launch counts (> 0 for both kernels), rate, ψ, rounds, host syncs,
   peak memory; served rows are members of their home piece and of no
   earlier piece (checked on the host against the base relations, sharing
   no code with the engine), and home frequencies follow the cover's
   selection law;
5. kernel entry point (``[ops]``) — ``repro_torch.kernels.ops`` driven on
   the card with the launch counts set to 0 just before and read just after
   (> 0 for every kernel): ``segdegree`` on every sorted key column of
   UQ1_J0, on 60,000,000 TPC-H SF 10 ``l_orderkey`` values built on the card
   and on an all-equal column of the same size (exact against the plain
   version); ``decode_attention`` at gemma-2-9b's widths (B 8, S 8192, 16
   query and 8 KV heads, D 256, bf16, softcap 50) for a global and a local
   (window 4096) layer, and a global layer whose logits reach the
   softcap's range (within rtol 1e-2, atol 1e-3 of the plain version in
   fp32; the kernel at softcap 0 must fail that limit on the last);
   ``searchsorted``, ``walk_hop`` and ``ranged_weighted_pick`` equal to the
   same calls on CPU tensors.  Edge sweeps of both kernels, and times
   against the bound, the plain version and the library call
   (``torch.unique_consecutive``; ``scaled_dot_product_attention`` at
   softcap 0); for both the bound shares and the ratios to the library;
   for ``segdegree`` its launches per call, CTAs (one wave) and the ptxas
   report of both key widths; for decode attention its CTAs (one wave) and
   the ptxas report of the bf16, D 256, G 2 instantiation that these
   widths launch;
6. residual path — UQ4 (the §8.2 residual node runs ``probe_pick``;
   before its serve, ``probe_pick`` is timed at the residual index);
7. branching tree — UQ3 at the UQ1 scale: every join, the branching
   ``UQ3_JA`` among them, draws identically through the kernels and the
   plain versions (every UQ3 node is uniform, so each runs ``probe_pick``);
8. §8.3 predicates — UQ2 at the UQ1 scale, served: ``[uq2]`` in pushdown
   mode (the three flavours' masked indexes share one device tensor per
   base node; every node is weighted, so ``sorted_probe`` only),
   ``[uq2-rejection]`` in rejection mode (in-round predicate masks,
   ``pred_rejects`` > 0, both probes), each over the exact warm-up's cover
   (computed once, in pushdown mode: both modes have the same union) and
   with kernel draws held equal to plain draws on all three flavours and
   every served row in its home piece's filtered join only;
   ``[uq2-adaptive]``: the pushdown state under ``plan="adaptive"``,
   served and checked the same way; ``[uq2-cli]``: the serve CLI as a user
   runs it, ``--workload UQ2 --plan adaptive`` (histogram warm-up, whose
   cover gives JP and JS no mass at this scale, as the reference's does);
   ``[record]``: UQ2 pushdown with ``membership="record"``, three
   ``sample(4096)`` calls (revisions, debited rows, rounds, rows in their
   home piece; a row may be credited to a later piece that holds it, since
   the lazy record learns a tuple's first piece only when it draws it);
9. wander join on the UQ1 state (after ``[uq3]``) — ``[walks]``: every
   UQ1 ``TorchWalkJoin`` walks identically through ``probe_pick`` and its
   plain version on the same root positions and uniforms (rows, float32
   probabilities, ``ok``), ``probe_pick`` timed at the largest hop with one
   walk batch (512 queries) beside its bound, the launches per ``observe``;
   ``[rw-warmup]``: ``warmup(method="random_walk", device="cuda")``, its
   time, each join's estimate within 3 half-widths of the exact EW size,
   the piece sizes beside the histogram cover's; ``[online]``:
   ``OnlineUnionSampler(backend="torch", phi=256, rw_batch=256)`` for two
   ``sample(n)`` calls (rate, ψ, reuse, refreshes, backtracking, the time
   in init, refreshes, membership probes and source refills, walk and draw
   launches), every row in its home piece only;
10. baselines, façades and the sharded engine on the UQ1 state (after
   ``[online]``; one ``TorchBackend`` serves the first four, each with the
   launch counts set to 0 just before its path and read just after, and
   both probes must launch on every path) — ``[baselines]``:
   ``BernoulliUnionSampler.sample(8192)`` over the exact EW join sizes and
   ``[rw-warmup]``'s union estimate (rows in their home join and no earlier
   one) and ``DisjointUnionSampler.sample(65536)`` (rows in their home
   join, home shares within 6σ + 0.002 of ``|J_j|/Σ|J|``), then Bernoulli
   at UQ1 scale 0.05 against the reference's bar (80·U rows, chi-square
   p > 1e-3); ``[chain]``: ``TorchChainSampler`` over UQ1_J0, kernel draws
   equal to plain draws, the rate of ``sample_uniform(65536)``;
   ``[replicas]``: two ``seed-split`` ``DistributedUnionSampler`` replicas,
   each captured by one warm-up call (timed apart), in one
   ``SampleService`` (8 × 4096, rows in their home piece only), a
   ``hash-partition`` rank 0 of 2 (every row in partition 0) and
   ``merge_streams``; ``[sharded]``: ``SetUnionSampler(mesh=
   make_sampler_mesh(world=1))`` and the adaptive ``ShardedUnionSampler``
   on its ``ShardedCatalog``, three ``sample(8192)`` each, bit-equal to the
   unsharded engine with the same seed (rows, homes, fingerprints,
   ``SamplerStats``), and both engines' rates in turns;
   ``[sharded-est]``: ``warmup(method="random_walk", mesh=world 1)`` equal
   to ``[rw-warmup]`` (sizes, half-widths, walks, the cover's union);
   ``[shards-cli]``: the serve CLI with ``--shards 1`` (UQ1 at
   ``SHARDS_SCALE``, 4 requests); ``[sharded-w2]``: two processes on the
   one card in a gloo group (NCCL refuses two ranks on one device), UQ1 at
   ``SHARDS_SCALE`` with ``shards=2``, 4 × 4096 on each rank: the same
   stream on both ranks (a SHA-256 of the rows), rows in their home piece;
11. small-input reference — UQ1 (static and adaptive) and UQ2 (pushdown,
   rejection and record mode) at scale 0.05 are sampled uniformly over
   their exact unions (chi-square), on the card, and every row is in its
   home piece and in no earlier one (record mode included); ONLINE UQ1 at
   scale 0.05 meets the reference's Algorithm-2 bar (``sample(40·U)``:
   ≥ 0.9·U distinct rows, max count ≤ 12× the mean, reuse accepts > 0).

Every served path runs the engine's default round loop,
``fused_rounds="device"``: one round captured as a CUDA graph per capacity
class and replayed in chunks, one host sync per chunk; a replay adds the
kernels recorded in one round to the launch counts.

Between 4 and 5, ``[adaptive]`` serves the same UQ1 state under
``plan="adaptive"`` as ``[main]`` serves it under the static plan, with its
``[profile]`` split and ``[main]``'s numbers beside its own.  Then
``[device-loop]`` holds the device loop bit-equal to the host loop
(``fused_rounds="host"``) from one seed on the same UQ1 state under both
plans, over ``sample(n)`` calls that cross capacity classes (rows, homes,
fingerprints, ``SamplerStats``, per-piece counters, then the carry and the
Philox offset), with rounds, chunks, host syncs (chunks + 1) and wasted
rounds per call and the capture seconds per class; under the static plan
it also prints both modes' engine rates in turns and both modes'
``[profile]`` split with the device busy share.  The same parity runs on
UQ4 after ``[residual]`` (B2 on the residual hop) and on UQ2 rejection
after ``[uq2-rejection]`` (predicate masks).  After each parity run one
more device-mode call runs under the profiler: its probe kernel events
(inside graph replays) must equal exactly the launches recorded in one
captured round × the rounds replayed, which is what the launch counts add.
``[metrics]`` serves UQ1 with a ``MetricsServer`` on an ephemeral port and
scrapes ``/healthz`` and ``/metrics`` over localhost: the engine and serve
series, under the reference's names, equal the engine's counters.  The
``kernels`` rows of ``sorted_probe`` and ``probe_pick`` give their launches
on each served path (``launches_by_path``; the online sampler's walks and
draws, the random-walk warm-up, the baselines, the chain façade, the
replicas, the sharded engine and its warm-up, the ``--shards 1`` CLI and
rank 0 of ``[sharded-w2]`` among them), and the ``probe_pick`` row
its time at walk width (``walk_ms`` and the ``walk_`` keys).

The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``.  Without a card it exits 1 and prints no
result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# H100 SXM published peaks (NVIDIA data sheet; rates assume the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # non-tensor 32-bit rate, used for int compares
BF16_OPS_PER_S = 989e12         # dense bf16 tensor-core rate

# gemma-2-9b's attention widths (src/repro/configs/gemma2_9b.py:8-11) and
# its context length; a batch of 8 decoding requests
GEMMA2_9B = {"H": 16, "KVH": 8, "D": 256, "softcap": 50.0, "window": 4096}
ATTN_BATCH, ATTN_SEQ = 8, 8192
# l_orderkey at TPC-H SF 10: 15 M orders of 1-7 lines each, ~60 M lines
SF10_LINES = 60_000_000
I64_MAX = np.iinfo(np.int64).max
# the full run's workload scales (UQ1 100 ≈ TPC-H SF 1); the variants
# script probes the indexes built at these scales
UQ1_SCALE, UQ4_SCALE = 100.0, 10.0
# [online]'s first sample(n) (the second asks for 2n) and [rw-warmup]'s walk
# budget per overlap term (the reference's warmup default).  The run keeps
# each of these phases under 45 s: at n = 1024 [online] took 42.5-49.1 s on
# an H100 (PERF.md), so it runs at half of it and [cut] says so
ONLINE_SAMPLES, RW_MAX_WALKS = 1024, 20_000
ONLINE_SAMPLES_RUN = ONLINE_SAMPLES // 2
# UQ1's scale for the serve CLI with --shards 1 and the two gloo ranks of
# [sharded-w2] (the quick run's scale): [sharded] serves the full scale
SHARDS_SCALE = 1.0


def _card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _call_ms(fn, reps: int = 200, warm: int = 10) -> float:
    """Time per call between CUDA events over ``reps`` back-to-back calls:
    the device time when the device is the bottleneck, the host's launch
    time when it is not."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# profiler sessions that came back with no device activity and were run
# again (printed on the [profiler] line)
EMPTY_TRACES = [0]
# profiler sessions tried before a call is said to have no device activity
PROFILER_ATTEMPTS = 3


def _device_events(fn, reps: int):
    """The device activity (kernels, copies) of ``reps`` calls of ``fn``,
    from torch.profiler: a list of (name, microseconds).  A session that
    records no device activity at all is run again, at most
    ``PROFILER_ATTEMPTS`` times in all, and counted in ``EMPTY_TRACES``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILER_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
              if e.device_type == DeviceType.CUDA]
        if ev:
            return ev
        EMPTY_TRACES[0] += 1
    raise AssertionError(f"torch.profiler recorded no device activity in "
                         f"{PROFILER_ATTEMPTS} sessions")


def _device_ms(fn, reps: int = 100, warm: int = 10) -> float:
    """Device time per call: the summed durations of every kernel the call
    launches (profiler), independent of the host's launch overhead."""
    for _ in range(warm):
        fn()
    return sum(us for _, us in _device_events(fn, reps)) / reps / 1e3


def _device_us_by_op(fn, reps: int = 100, warm: int = 10) -> dict:
    """Device microseconds per call of ``fn``, by kernel or copy name."""
    for _ in range(warm):
        fn()
    out: dict = {}
    for name, us in _device_events(fn, reps):
        out[name] = out.get(name, 0.0) + us / reps
    return out


def _kernel_event_ms(fn, match: str, reps: int = 100, warm: int = 10):
    """Mean device ms of the profiler's events whose name contains
    ``match``, and how many such events each call produced: a per-event
    mean stays right if the profiler drops some of a small kernel's
    records."""
    for _ in range(warm):
        fn()
    us = [t for name, t in _device_events(fn, reps) if match in name]
    if not us:
        raise AssertionError(f"the profiler recorded no {match} event")
    return sum(us) / len(us) / 1e3, len(us) / reps


def _keys_touched(keys, queries) -> int:
    """Distinct key positions that the lower- and upper-bound searches of
    this query batch compare against (the kernels' search, replayed level by
    level with torch): the keys the function must read, each counted once."""
    import torch
    n = keys.numel()
    if n == 0 or queries.numel() == 0:
        return 0
    seen = []
    for less in (True, False):
        base = torch.zeros_like(queries, dtype=torch.int64)
        length = n
        while length > 1:
            half = length >> 1
            idx = base + half
            seen.append(idx)
            k = keys[idx]
            go = k < queries if less else k <= queries
            base = torch.where(go, idx, base)
            length -= half
        seen.append(base)
    return int(torch.unique(torch.cat(seen)).numel())


def _bound(keys, queries, pick: bool):
    """Least time for the work: bytes moved (queries and uniforms read once,
    outputs written once, and each distinct key the searches of this batch
    compare read once) over HBM bandwidth, against the comparisons over the
    32-bit ALU rate.  Returns (ms, bound_by)."""
    n_keys, nq = keys.numel(), queries.numel()
    key_bytes = keys.element_size()
    levels = max(1, math.ceil(math.log2(n_keys + 1)))
    nbytes = (_keys_touched(keys, queries) * key_bytes + nq * key_bytes
              + 2 * nq * 4)
    ops = 2 * nq * levels
    if pick:
        nbytes += nq * 4
        ops += 6 * nq
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _search_levels(n: int, group: int) -> int:
    """Dependent loads of the probes' group search over n keys: each
    level leaves at most floor(len / (group + 1)) keys unread, and the last
    reads the at most ``group`` keys left."""
    levels = 0
    while n > 0:
        levels += 1
        n = 0 if n <= group else n // (group + 1)
    return levels


def _launches_per_call(kernel: str, fn) -> int:
    """Kernels that one call of ``fn`` adds to ``launch_counts[kernel]``."""
    import torch
    from repro_torch.kernels import build
    before = build.launch_counts[kernel]
    fn()
    torch.cuda.synchronize()
    return build.launch_counts[kernel] - before


def _ptxas_pair(kernel: str, group=None, log=None) -> dict:
    """The ptxas report of the int32 and int64 instantiations of a kernel
    templated on its key type (and on its group width, for the probes)."""
    from repro_torch.kernels import build
    log = build.build()["log"] if log is None else log
    g = "" if group is None else f"Li{group}E"
    return {"int32": _ptxas_stats(log, kernel, f"kernelIi{g}E"),
            "int64": _ptxas_stats(log, kernel, f"kernelIl{g}E")}


def _check_equal(a, b, what: str) -> None:
    import torch
    for x, y in zip(a, b):
        if x.shape != y.shape or not torch.equal(x, y):
            bad = int((x != y).sum()) if x.shape == y.shape else -1
            raise AssertionError(f"{what}: kernel and plain version differ "
                                 f"({bad} mismatching elements)")


def _max_abs_err(a, b) -> int:
    return max(int((x.long() - y.long()).abs().max()) if x.numel() else 0
               for x, y in zip(a, b))


def phase_edge_sweeps() -> int:
    """Kernel vs plain on the shared edge cases and the large card case,
    with the shared pick uniforms (0, 1⁻ and products that land on an
    integer); returns the number of cases."""
    import torch
    from repro_torch.kernels import probe
    from repro_torch.kernels.cases import (PROBE_CARD_CASES, PROBE_CASES,
                                           key_dtypes, probe_case,
                                           probe_uniforms)
    names = PROBE_CASES + PROBE_CARD_CASES
    for name in names:
        keys, qs = probe_case(name)
        u = torch.as_tensor(probe_uniforms(name, qs.shape[0]), device="cuda")
        for dt in key_dtypes(keys, qs):
            k = torch.as_tensor(keys, device="cuda").to(dt)
            q = torch.as_tensor(qs, device="cuda").to(dt)
            _check_equal(probe.sorted_probe(k, q), probe.sorted_probe_plain(k, q),
                         f"sorted_probe edge case {name} {dt}")
            _check_equal(probe.probe_pick(k, q, u),
                         probe.probe_pick_plain(k, q, u),
                         f"probe_pick edge case {name} {dt}")
    torch.cuda.synchronize()
    return len(names)


def _node_queries(tree, node: int, batch: int):
    """Real queries for ``node`` of ``tree``: the packed parent keys of one
    batch of draws (plain path, so no kernel launch is counted)."""
    import torch
    from repro_torch.core.backends.torch_backend import _pack
    u = torch.rand((tree.n_streams, batch), device="cuda")
    rows, _, _ = tree.draw(u, plain=True)
    cfg = tree.node_cfgs[node]
    return _pack(rows, cfg.edge_attrs, cfg.radices).contiguous()


def phase_kernels(sampler) -> list:
    """Main-path shapes: one piece batch of queries against UQ1_J0's orders
    index (the largest ``sorted_probe`` sees) and lineitem index (what
    ``probe_pick`` sees; ``sorted_probe`` is timed there too).
    ``probe_pick`` is also timed against the port's two-step route on the
    same inputs: ``sorted_probe`` and then ``pick_from_range``."""
    import torch
    from repro_torch.kernels import build, probe
    tree = sampler.backend.trees[sampler.order[0]]
    batch = sampler.engine.piece_batches[0]
    weighted = [i for i, c in enumerate(tree.node_cfgs)
                if c.kind == "tree" and not c.uniform]
    uniform = [i for i, c in enumerate(tree.node_cfgs) if c.uniform]
    i_w = max(weighted, key=lambda i: tree.sorted_keys[i].numel())
    i_u = max(uniform, key=lambda i: tree.sorted_keys[i].numel())
    out = []
    for name, i in (("sorted_probe", i_w), ("probe_pick", i_u)):
        keys = tree.sorted_keys[i]
        q = _node_queries(tree, i, batch)
        u = torch.rand(q.shape[0], device="cuda")
        if name == "sorted_probe":
            kern = lambda: probe.sorted_probe(keys, q)            # noqa: E731
            plain = lambda: probe.sorted_probe_plain(keys, q)     # noqa: E731
            lib = lambda: (torch.searchsorted(keys, q, side="left"),  # noqa: E731
                           torch.searchsorted(keys, q, side="right"))
        else:
            kern = lambda: probe.probe_pick(keys, q, u)           # noqa: E731
            plain = lambda: probe.probe_pick_plain(keys, q, u)    # noqa: E731
            lib = None

            def composite():
                lo, hi = probe.sorted_probe(keys, q)
                return probe.pick_from_range(lo, hi - lo, u), hi - lo
        a, b = kern(), plain()
        torch.cuda.synchronize()
        _check_equal(a, b, f"{name} at main-path shape")
        bound_ms, bound_by = _bound(keys, q, pick=name == "probe_pick")
        row = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/probe.cu",
            "replaces": ("src/repro/kernels/searchsorted.py:73,105"
                         if name == "sorted_probe"
                         else "src/repro/kernels/walk.py:26"),
            "launches": 0, "max_abs_err": _max_abs_err(a, b),
            "ms": _device_ms(kern), "plain_ms": _device_ms(plain),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": _device_ms(lib) if lib is not None else None,
            "call_ms": _call_ms(kern), "plain_call_ms": _call_ms(plain),
            "n_keys": keys.numel(), "n_queries": q.numel(),
            "keys_touched": _keys_touched(keys, q),
            "node": f"{tree.name}/{tree.node_cfgs[i].alias}",
        }
        if name == "sorted_probe":
            # the lineitem index (3.6 M keys at scale 100) as well
            lk = tree.sorted_keys[i_u]
            lq = _node_queries(tree, i_u, batch)
            _check_equal(probe.sorted_probe(lk, lq),
                         probe.sorted_probe_plain(lk, lq),
                         "sorted_probe at the lineitem index")
            row["lineitem_ms"] = _device_ms(lambda: probe.sorted_probe(lk, lq))
            row["lineitem_library_ms"] = _device_ms(
                lambda: (torch.searchsorted(lk, lq, side="left"),
                         torch.searchsorted(lk, lq, side="right")))
            row["lineitem_bound_ms"] = _bound(lk, lq, pick=False)[0]
            g = build.load().repro_sorted_probe_group()
            row.update({
                "G": g, "levels": _search_levels(keys.numel(), g),
                "lineitem_levels": _search_levels(lk.numel(), g),
                "binary_search_levels": math.ceil(math.log2(keys.numel() + 1)),
                "bound_share": bound_ms / row["ms"],
                "lineitem_bound_share": (row["lineitem_bound_ms"]
                                         / row["lineitem_ms"]),
                "vs_library": row["ms"] / row["library_ms"],
                "lineitem_vs_library": (row["lineitem_ms"]
                                        / row["lineitem_library_ms"]),
                "launches_per_call": _launches_per_call("sorted_probe", kern),
                "ptxas": _ptxas_pair("sorted_probe_kernel", g),
            })
        else:
            _check_equal(composite(), b, "sorted_probe + pick_from_range at "
                         "main-path shape")
            g = build.load().repro_probe_pick_group()
            row.update({
                "G": g, "levels": _search_levels(keys.numel(), g),
                "binary_search_levels": math.ceil(math.log2(keys.numel() + 1)),
                "bound_share": bound_ms / row["ms"],
                "composite_ms": _device_ms(composite),
                "launches_per_call": _launches_per_call("probe_pick", kern),
                "ptxas": _ptxas_pair("probe_pick_kernel", g),
            })
            row["vs_composite"] = row["ms"] / row["composite_ms"]
        row["kernel_ms"] = row["ms"]
        row["bound_us"] = bound_ms * 1e3
        out.append(row)
    return out


def phase_draw_parity(sampler, batch: int) -> int:
    """Every tree of ``sampler`` draws the same through the kernels and the
    plain versions on two seeds of uniforms; returns the draws compared."""
    import torch
    n = 0
    for name in sampler.order:
        tree = sampler.backend.trees[name]
        for seed in range(2):
            g = torch.Generator(device="cuda")
            g.manual_seed(seed)
            u = torch.rand((tree.n_streams, batch), generator=g, device="cuda")
            k_rows, k_acc, k_ok = tree.draw(u)
            p_rows, p_acc, p_ok = tree.draw(u, plain=True)
            _check_equal([k_rows[a] for a in tree.attrs] + [k_acc, k_ok],
                         [p_rows[a] for a in tree.attrs] + [p_acc, p_ok],
                         f"draw parity {name}")
            n += 1
    torch.cuda.synchronize()
    return n


def _residual_inputs(sampler):
    """The residual index of a cyclic sampler's tree (UQ4's ``pref``) and
    one piece batch of real queries for it: ``(node name, keys, queries)``."""
    tree = next(t for t in sampler.backend.trees.values() if t.has_residual)
    i = next(i for i, c in enumerate(tree.node_cfgs) if c.kind == "residual")
    q = _node_queries(tree, i, sampler.engine.piece_batches[
        sampler.order.index(tree.name)])
    return f"{tree.name}/{tree.node_cfgs[i].alias}", tree.sorted_keys[i], q


def phase_residual_probe(sampler) -> dict:
    """``probe_pick`` at the residual index of a cyclic sampler with one
    piece batch of real queries: exact against the plain version; device
    times of both and the bound."""
    import torch
    from repro_torch.kernels import build, probe
    node, keys, q = _residual_inputs(sampler)
    u = torch.rand(q.shape[0], device="cuda")
    kern = lambda: probe.probe_pick(keys, q, u)                   # noqa: E731
    plain = lambda: probe.probe_pick_plain(keys, q, u)            # noqa: E731
    _check_equal(kern(), plain(), "probe_pick at the residual index")
    g = build.load().repro_probe_pick_group()
    return {"residual_ms": _device_ms(kern),
            "residual_plain_ms": _device_ms(plain),
            "residual_bound_ms": _bound(keys, q, pick=True)[0],
            "residual_n_keys": keys.numel(), "residual_n_queries": q.numel(),
            "residual_levels": _search_levels(keys.numel(), g),
            "residual_node": node}


def phase_branching_tree(scale: float, round_batch: int) -> dict:
    """UQ3 built on the card at ``scale``: every join's draws, the branching
    ``UQ3_JA`` among them, equal through the kernels and the plain versions;
    the kernels these draws launch (``probe_pick`` only: every UQ3 node is
    uniform)."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.serve import build_sampler
    sampler, wl, _, build_s = build_sampler("UQ3", scale, seed=0,
                                            device="cuda",
                                            round_batch=round_batch)
    parents = [n.parent for n in wl.joins[0].nodes]
    if max(parents.count(n.alias) for n in wl.joins[0].nodes) < 2:
        raise AssertionError("[uq3] UQ3_JA has no branching node")
    build.reset_launch_counts()
    n = phase_draw_parity(sampler, max(sampler.engine.piece_batches))
    launches = dict(build.launch_counts)
    if launches["probe_pick"] <= 0:
        raise AssertionError("[uq3] the draws launched no probe_pick")
    torch.cuda.synchronize()
    return {"draws": n, "launches": launches, "host_build_s": build_s,
            "scale": scale,
            "rows_per_node": [[nd.relation.nrows for nd in j.nodes]
                              for j in wl.joins],
            "piece_batches": list(sampler.engine.piece_batches)}


def _rows_in_relation(rel, rows) -> np.ndarray:
    """Whether each row's projection onto ``rel``'s attributes is a row of
    ``rel``: an exact lookup in the relation's host columns (records sorted
    field by field), sharing no code with the engine's fingerprint probes."""
    attrs = list(rel.attrs)
    dt = np.dtype([(a, "<i8") for a in attrs])
    sel = np.arange(rel.nrows)
    for a in attrs:                 # narrow to rows that could match at all
        sel = sel[np.isin(rel.columns[a][sel], rows[a])]
    table = np.empty(sel.size, dt)
    query = np.empty(len(rows[attrs[0]]), dt)
    for a in attrs:
        table[a] = rel.columns[a][sel]
        query[a] = rows[a]
    table.sort()
    if table.size == 0:
        return np.zeros(query.size, bool)
    i = np.minimum(np.searchsorted(table, query), table.size - 1)
    return table[i] == query


def _passes(preds, rows) -> np.ndarray:
    """Whether each row passes every §8.3 predicate, by the predicate's own
    numpy comparison."""
    keep = np.ones(len(next(iter(rows.values()))), bool)
    for p in preds:
        keep &= p.mask(rows)
    return keep


def _join_membership(joins, rows) -> np.ndarray:
    """(rows, joins) membership by the definition of a join: a row is in a
    join iff its projection onto every base relation of the join is a row
    of that relation (a pushdown's relations are the filtered ones) and it
    passes the join's rejection predicates."""
    return np.stack([np.logical_and.reduce(
        [_rows_in_relation(n.relation, rows) for n in j.nodes]
        + [_passes(j.reject_preds, rows)]) for j in joins], axis=1)


def _membership_matrix(sampler, rows) -> np.ndarray:
    """(rows, pieces) membership in cover order (:func:`_join_membership`)."""
    by_name = {j.name: j for j in sampler.joins}
    return _join_membership([by_name[n] for n in sampler.order], rows)


def check_membership(sampler, rows, home) -> None:
    """Each sample lies in its home piece and in no earlier cover piece."""
    mm = _membership_matrix(sampler, rows)
    if not mm.any(axis=1).all():
        raise AssertionError("a served row is in no join of the union")
    first = np.argmax(mm, axis=1)
    if not np.array_equal(first, home):
        raise AssertionError(f"{int((first != home).sum())} served rows are "
                             "credited to the wrong cover piece")


def check_record_membership(sampler, rows, home) -> int:
    """Record mode: each sample lies in its home piece.  The lazy record
    learns a tuple's first piece only when that piece draws it (Alg 1
    l.8-12), so a row may still be credited to a later piece that holds it;
    returns how many are."""
    mm = _membership_matrix(sampler, rows)
    if not mm[np.arange(home.size), home].all():
        raise AssertionError("a record-mode row is not in its home piece")
    return int((np.argmax(mm, axis=1) < home).sum())


def run_path(label: str, workload: str, scale: float, requests: int,
             samples: int, round_batch: int, required, before_serve=None,
             built=None) -> dict:
    """Build (or take ``built`` = (sampler, workload, estimates, build
    seconds)), then serve through SampleService with the launch counts set
    to 0 just before and read just after (each kernel in ``required`` must
    have launched); check what came out.  Returns the summary (``sampler``,
    ``wl`` and ``est`` included)."""
    import torch
    from repro_torch.kernels import probe
    from repro_torch.launch.serve import build_sampler, serve
    sampler, wl, est, build_s = built or build_sampler(
        workload, scale, seed=0, device="cuda", round_batch=round_batch)
    torch.cuda.synchronize()
    rows_per_node = [[n.relation.nrows for n in j.nodes] for j in wl.joins]
    print(f"[{label}] {workload} scale={scale}: host build {build_s:.1f}s, "
          f"rows per node {rows_per_node}, "
          f"piece batches {sampler.engine.piece_batches}", flush=True)
    if before_serve is not None:
        before_serve(sampler)
    sampler.sample(256)                               # warm-up call
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    probe.reset_launch_counts()
    out = serve(sampler, requests, samples, round_batch)
    torch.cuda.synchronize()
    out["launches"] = dict(probe.launch_counts)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    out["host_build_s"] = build_s
    out["scale"] = scale
    out["workload"] = workload
    out["plan"] = sampler.plan
    out["piece_batches"] = list(sampler.engine.piece_batches)
    for k in required:
        if out["launches"][k] <= 0:
            raise AssertionError(f"[{label}] kernel {k} was not launched on "
                                 "the path")
    # engine-only rate: back-to-back sample(round_batch) calls, synced
    eng = sampler.engine
    n_calls, emitted = 4, 0
    syncs0, rounds0 = eng.host_syncs, eng.total_rounds
    t0 = time.perf_counter()
    for _ in range(n_calls):
        emitted += len(sampler.sample(round_batch))
    torch.cuda.synchronize()
    out["engine_samples_per_s"] = emitted / (time.perf_counter() - t0)
    out["rounds_per_sample_call"] = (eng.total_rounds - rounds0) / n_calls
    out["host_syncs_per_sample_call"] = (eng.host_syncs - syncs0) / n_calls
    # what came out: a fresh sample's rows lie in their home piece only
    ss = sampler.sample(4096)
    if len(ss) != 4096:
        raise AssertionError(f"[{label}] sample size {len(ss)}")
    t0 = time.perf_counter()
    check_membership(sampler, ss.rows, ss.home)
    out["membership_check_s"] = time.perf_counter() - t0
    # home frequencies against the cover's selection law (binomial, 6 sigma
    # plus 0.002 for the shortfall carried across call boundaries)
    p = np.asarray(est.cover.selection_probs(), np.float64)
    homes = np.asarray(out["home_counts"], np.float64)
    f = homes / homes.sum()
    tol = 6 * np.sqrt(p * (1 - p) / homes.sum()) + 0.002
    out["home_freq"] = f.round(5).tolist()
    out["selection_probs"] = p.round(5).tolist()
    if out["dropped_slots"] == 0 and not (np.abs(f - p) <= tol).all():
        raise AssertionError(f"[{label}] home frequencies {f} differ from "
                             f"selection probabilities {p} (tol {tol})")
    out["sampler"], out["wl"], out["est"] = sampler, wl, est
    return out


def phase_shared_indexes(sampler) -> dict:
    """UQ2's pushdown flavours share one device tensor per base-node index,
    permutation and payload column (the catalog cache, keyed by relation
    identity): the same ``data_ptr()`` in every flavour."""
    trees = [sampler.backend.trees[n] for n in sampler.order]
    t0 = trees[0]
    if not all(t.masked for t in trees):
        raise AssertionError("[uq2] a pushdown flavour was built without "
                             "its masks")
    shared = 0
    for t in trees[1:]:
        pairs = list(zip(t.root_cols.values(), t0.root_cols.values()))
        for i in range(len(t0.node_cfgs)):
            pairs += [(t.sorted_keys[i], t0.sorted_keys[i]),
                      (t.perm[i], t0.perm[i])]
            pairs += [(t.cols[i][a], c) for a, c in t0.cols[i].items()]
        for x, y in pairs:
            if x.data_ptr() != y.data_ptr():
                raise AssertionError("[uq2] pushdown flavours hold separate "
                                     "copies of a base-node tensor")
        shared += len(pairs)
    return {"flavours": len(trees),
            "shared_tensors_per_flavour": shared // (len(trees) - 1),
            "base_nodes": len(t0.node_cfgs) + 1,
            "weighted_nodes": sum(not c.uniform for c in t0.node_cfgs)}


def phase_record(wl, est, round_batch: int, samples: int) -> dict:
    """UQ2 pushdown with ``membership="record"``: three sample(samples)
    calls (the first sizes the record to 4 × samples), with the launch
    counts set to 0 just before and read just after; every returned row lies
    in its home piece."""
    import torch
    from repro_torch.core.union_sampler import SetUnionSampler
    from repro_torch.kernels import probe
    calls = 3
    s = SetUnionSampler(wl.cat, wl.joins, est.cover, seed=0, device="cuda",
                        round_batch=round_batch, membership="record")
    torch.cuda.synchronize()
    probe.reset_launch_counts()
    rounds, syncs, outs = [], [], []
    t0 = time.perf_counter()
    for _ in range(calls):
        outs.append(s.sample(samples))
        rounds.append(s.engine.last_rounds)
        syncs.append(s.engine.last_host_syncs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(probe.launch_counts)
    later = 0
    for ss in outs:
        if len(ss) != samples:
            raise AssertionError(f"[record] sample size {len(ss)}")
        later += check_record_membership(s, ss.rows, ss.home)
    if launches["sorted_probe"] <= 0:
        raise AssertionError("[record] the path launched no sorted_probe")
    st = s.stats
    return {"calls": calls, "samples": samples, "seconds": dt,
            "samples_per_s": calls * samples / dt, "rounds_per_call": rounds,
            "host_syncs_per_call": syncs, "revisions": st.revisions,
            "backtrack_removed": st.backtrack_removed,
            "cover_rejects": st.cover_rejects, "psi": st.psi(),
            "record_capacity": s.engine.R, "launches": launches,
            "rows_in_home_piece": True,
            "rows_credited_to_a_later_piece": later}


def phase_profile(sampler, round_batch: int, wall_s_per_call: float) -> dict:
    """Where the time of one ``sample(round_batch)`` goes: device time and
    kernel count per call (profiler), grouped by kernel family, and the
    device's busy share against the unprofiled wall time per call."""
    calls = 3
    ev = _device_events(lambda: sampler.sample(round_batch), calls)
    groups: dict = {}
    for name, us in ev:
        low = name.lower()
        fam = ("probe kernels (ours)" if "probe" in low and "kernel" in low
               else "memcpy/memset" if "memcpy" in low or "memset" in low
               else "searchsorted" if "searchsorted" in low
               else "index/gather" if "index" in low or "gather" in low
               else "scatter" if "scatter" in low
               else "scan/reduce" if ("scan" in low or "reduce" in low
                                      or "cumsum" in low)
               else "sort/unique" if "sort" in low or "unique" in low
               else "elementwise" if "elementwise" in low
               else "other")
        g = groups.setdefault(fam, [0, 0.0])
        g[0] += 1
        g[1] += us
    dev_us = sum(us for _, us in ev) / calls
    return {
        "wall_ms_per_call": wall_s_per_call * 1e3,
        "device_ms_per_call": dev_us / 1e3,
        "device_busy_share": dev_us / 1e6 / wall_s_per_call,
        "device_ops_per_call": len(ev) / calls,
        "by_family_ms_per_call": {k: round(v[1] / calls / 1e3, 4)
                                  for k, v in sorted(groups.items(),
                                                     key=lambda kv: -kv[1][1])},
        "by_family_ops_per_call": {k: v[0] / calls for k, v in groups.items()},
    }


def _lineitem_orderkeys(n: int, seed: int):
    """TPC-H ``l_orderkey`` built on the card: orders numbered as dbgen
    numbers them (the first 8 of every 32 keys), 1-7 lines each, uniform;
    the first ``n`` lines, sorted int64."""
    import torch
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    n_orders = n // 4 + 100_000                 # 4 lines per order on average
    lines = torch.randint(1, 8, (n_orders,), generator=g, device="cuda")
    i = torch.arange(n_orders, device="cuda")
    keys = torch.repeat_interleave((i // 8) * 32 + i % 8 + 1, lines)
    if keys.numel() < n:
        raise AssertionError(f"only {keys.numel()} lines drawn for {n}")
    return keys[:n].contiguous()


def _segdegree_bound(keys):
    """Each key read once (bytes) against one compare per key at the 32-bit
    ALU rate (two for an int64 key).  Returns (ms, bound_by)."""
    t_bytes = keys.numel() * keys.element_size() / HBM_BYTES_PER_S * 1e3
    t_ops = keys.numel() * keys.element_size() / 4 / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _attention_bound(q, k, lengths, window: int):
    """Bytes: q, lengths and the output once, and each K and V row that the
    masks keep once; operations: 4·D flops per kept (row, query head) at the
    bf16 tensor-core rate for bf16 inputs (fp32 otherwise).  Returns
    (ms, bound_by)."""
    import torch
    B, H, D = q.shape
    S, KVH = k.shape[1], k.shape[2]
    lens = lengths.long().clamp(min=0)
    lo = (lens - window).clamp(min=0) if window > 0 else torch.zeros_like(lens)
    kept = int((lens.clamp(max=S) - lo).clamp(min=0).sum())
    nbytes = (2 * kept * KVH * D * k.element_size()
              + 2 * B * H * D * q.element_size()
              + lengths.numel() * lengths.element_size())
    rate = BF16_OPS_PER_S if k.dtype == torch.bfloat16 else FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = kept * H * 4 * D / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _ptxas_stats(log: str, kernel: str, instance: str) -> dict:
    """Registers, spills and static shared memory that nvcc's ``-Xptxas -v``
    report gives the kernel whose mangled name holds ``kernel`` and
    ``instance``."""
    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and kernel in ln and instance in ln:
            out = {"instance": instance}
            for nxt in lines[i + 1:i + 4]:
                words = nxt.replace(",", "").split()
                for j, w in enumerate(words[1:], 1):
                    if w == "registers":
                        out["registers"] = int(words[j - 1])
                    elif w == "spill" and words[j + 1] in ("stores", "loads"):
                        out["spill_" + words[j + 1] + "_bytes"] = int(
                            words[j - 2])
                    elif w == "smem":
                        out["smem_bytes"] = int(words[j - 2])
            return out
    raise AssertionError(f"no ptxas report for {kernel} {instance}")


def phase_ops_sweeps() -> dict:
    """segdegree and decode attention against their plain versions on the
    shared edge cases (``repro_torch.kernels.cases``): segdegree exact
    (int64, and int32 where the keys fit; misaligned views, and runs on the
    kernel's own CTA-range boundaries); decode attention within
    ``attention_tol`` of the plain version in fp32 from the same inputs."""
    import torch
    from repro_torch.kernels import attention, segdegree
    from repro_torch.kernels.cases import (ATTENTION_CASES,
                                           SEGDEGREE_CARD_CASES,
                                           SEGDEGREE_CASES, attention_case,
                                           attention_tol, key_dtypes,
                                           segdegree_card_case)
    n_seg = 0
    dev = torch.device("cuda", 0)
    for name in SEGDEGREE_CASES + SEGDEGREE_CARD_CASES:
        for dt in (torch.int64, torch.int32):
            # the boundary cases follow the CTA ranges of a call of this width
            width = 4 if dt == torch.int32 else 8
            base, off = segdegree_card_case(
                name, lambda n: segdegree.cta_keys(n, width, dev))
            if dt not in key_dtypes(base):
                continue
            kt = torch.as_tensor(base, device="cuda").to(dt)[off:]
            got, want = segdegree.segdegree(kt), segdegree.segdegree_plain(kt)
            if got != want:
                raise AssertionError(f"segdegree {name} {dt}: kernel {got} "
                                     f"!= plain {want}")
            n_seg += 1
    errs = {}
    for name in ATTENTION_CASES:
        c = attention_case(name)
        dt, cap, win = c["dtype"], c["softcap"], c["window"]
        q, k, v = (torch.as_tensor(c[x], device="cuda").to(dt) for x in "qkv")
        lens = torch.as_tensor(c["lens"], device="cuda")
        out = attention.decode_attention(q, k, v, lens, softcap=cap,
                                         window=win)
        want = attention.decode_attention_plain(q.float(), k.float(),
                                                v.float(), lens, softcap=cap,
                                                window=win)
        torch.testing.assert_close(out.float(), want, **attention_tol(dt))
        errs[name] = float((out.float() - want).abs().max())
    torch.cuda.synchronize()
    return {"segdegree_cases": n_seg, "attention_cases": len(errs),
            "attention_max_abs_err": errs}


def _excess(got, want, tol) -> float:
    """The largest amount by which |got - want| exceeds atol + rtol·|want|
    (negative when every element is inside the limit)."""
    return float(((got.float() - want).abs()
                  - (tol["atol"] + tol["rtol"] * want.abs())).max())


def phase_ops(sampler, seed: int):
    """Drive ``repro_torch.kernels.ops`` on the card with the launch counts
    set to 0 just before and read just after (every kernel must launch);
    check what came out; time ``segdegree`` and ``decode_attention``.
    Decode attention runs a global and a local layer with q of std 1 (logits
    of std 1), and a global layer with q of std softcap / 2, where tanh
    bends the logits; a control, the same kernel at softcap 0, must fail
    the tolerance there.  Returns (kernel rows, summary)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attention, build, ops, segdegree
    from repro_torch.kernels.cases import attention_tol

    tree = sampler.backend.trees[sampler.order[0]]
    cols = list(tree.sorted_keys)
    big = _lineitem_orderkeys(SF10_LINES, seed)
    same = torch.full_like(big, I64_MAX)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    cfg = GEMMA2_9B
    B, S, H, KVH, D = ATTN_BATCH, ATTN_SEQ, cfg["H"], cfg["KVH"], cfg["D"]
    q, k, v = (torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
               for s in ((B, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    lens = torch.randint(S // 2, S + 1, (B,), generator=g, device="cuda")
    # B1 and B2 through ops: the lineitem index with one piece batch of real
    # queries; the weighted pick over 2^20 prefix sums
    i_u = max((i for i, c in enumerate(tree.node_cfgs) if c.uniform),
              key=lambda i: tree.sorted_keys[i].numel())
    lk = tree.sorted_keys[i_u]
    lq = _node_queries(tree, i_u, sampler.engine.piece_batches[0])
    lu = torch.rand(lq.shape, generator=g, device="cuda")
    w = torch.rand(1 << 20, generator=g, device="cuda", dtype=torch.float64)
    w[torch.rand(w.shape, generator=g, device="cuda") < 0.3] = 0.0
    cs = torch.cat([w.new_zeros(1), w.cumsum(0)])
    plo = torch.randint(0, w.numel() - 50, (8192,), generator=g, device="cuda")
    phi = plo + torch.randint(1, 50, (8192,), generator=g, device="cuda")
    pu = torch.rand(8192, generator=g, device="cuda", dtype=torch.float64)
    q_cap = (torch.randn((B, H, D), generator=g, device="cuda")
             * (cfg["softcap"] / 2)).to(torch.bfloat16)
    layers = {"global": (q, 0), "local": (q, cfg["window"]),
              "global_softcap_range": (q_cap, 0)}
    torch.cuda.synchronize()

    build.reset_launch_counts()
    t0 = time.perf_counter()
    degrees = [ops.segdegree(c) for c in cols + [big, same]]
    att = {name: ops.decode_attention(qq, k, v, lens, softcap=cfg["softcap"],
                                      window=win)
           for name, (qq, win) in layers.items()}
    ss = ops.searchsorted(lk, lq)
    wh = ops.walk_hop(lk, lq, lu)
    rp = ops.ranged_weighted_pick(cs, plo, phi, pu)
    torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"[ops] kernels not launched on the ops path: "
                             f"{missing}")

    # what came out
    for c, got in zip(cols + [big, same], degrees):
        if got != segdegree.segdegree_plain(c):
            raise AssertionError(f"[ops] segdegree of {c.numel()} keys: "
                                 f"{got} != plain")
    if degrees[-1] != (1, SF10_LINES):
        raise AssertionError(f"[ops] all-equal column gave {degrees[-1]}")
    tol = attention_tol(torch.bfloat16)
    att_err, nocap_excess = {}, {}
    for name, out in att.items():
        qq, win = layers[name]
        want = attention.decode_attention_plain(
            qq.float(), k.float(), v.float(), lens, softcap=cfg["softcap"],
            window=win)
        torch.testing.assert_close(out.float(), want, **tol)
        att_err[name] = float((out.float() - want).abs().max())
        if win == 0:
            # control: the kernel without the softcap, against the same limit
            nocap = attention.decode_attention(qq, k, v, lens, window=win)
            nocap_excess[name] = _excess(nocap, want, tol)
        del want
    if nocap_excess["global_softcap_range"] <= 0:
        raise AssertionError("[ops] the attention tolerance does not tell a "
                             "kernel without the softcap from the right one")

    def on_cpu(*ts):
        return [t.cpu() for t in ts]
    _check_equal(on_cpu(*ss), ops.searchsorted(*on_cpu(lk, lq), device="cpu"),
                 "[ops] searchsorted on the card vs on the CPU")
    _check_equal(on_cpu(*wh), ops.walk_hop(*on_cpu(lk, lq, lu), device="cpu"),
                 "[ops] walk_hop on the card vs on the CPU")
    _check_equal(on_cpu(rp), [ops.ranged_weighted_pick(
        *on_cpu(cs, plo, phi, pu), device="cpu")],
        "[ops] ranged_weighted_pick on the card vs on the CPU")

    # segdegree: the SF 10 column; the all-equal column and the UQ1 lineitem
    # index beside it
    i_big = len(cols)
    b_ms, b_by = _segdegree_bound(big)
    seg_row = {
        "name": "segdegree", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segdegree.cu",
        "replaces": "src/repro/kernels/segdegree.py:30",
        "launches": launches["segdegree"], "path": "ops", "max_abs_err": 0,
        "ms": _device_ms(lambda: segdegree.segdegree(big), reps=50),
        "plain_ms": _device_ms(lambda: segdegree.segdegree_plain(big),
                               reps=5, warm=2),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": _device_ms(
            lambda: torch.unique_consecutive(big, return_counts=True),
            reps=5, warm=2),
        "n_keys": big.numel(), "distinct": degrees[i_big][0],
        "max_degree": degrees[i_big][1],
        "all_equal_ms": _device_ms(lambda: segdegree.segdegree(same), reps=50),
        "lineitem_n_keys": lk.numel(),
        "lineitem_ms": _device_ms(lambda: segdegree.segdegree(lk), reps=50),
        "lineitem_bound_ms": _segdegree_bound(lk)[0],
        "lineitem_library_ms": _device_ms(
            lambda: torch.unique_consecutive(lk, return_counts=True), reps=20),
        "uq1_columns": [[c.numel()] + list(d) for c, d in zip(cols, degrees)],
        # what one call at the lineitem index puts on the device (the
        # ticket's memset and the kernel), and the fixed cost of a call
        "lineitem_device_us_by_op": _device_us_by_op(
            lambda: segdegree.segdegree(lk), reps=50),
        "one_cta_ms": _device_ms(lambda: segdegree.segdegree(lk[:2048]),
                                 reps=50),
        "launches_per_call": _launches_per_call(
            "segdegree", lambda: segdegree.segdegree(big)),
        # one wave of CTAs, each an equal range of the column
        "ctas": min(segdegree.kernel_wave(8, big.device),
                    -(-big.numel() // segdegree.cta_keys(big.numel(), 8,
                                                         big.device))),
        "ptxas": _ptxas_pair("segdegree_kernel"),
    }
    seg_row["bound_share"] = b_ms / seg_row["ms"]
    seg_row["lineitem_bound_share"] = (seg_row["lineitem_bound_ms"]
                                       / seg_row["lineitem_ms"])
    seg_row["vs_library"] = seg_row["ms"] / seg_row["library_ms"]
    seg_row["lineitem_vs_library"] = (seg_row["lineitem_ms"]
                                      / seg_row["lineitem_library_ms"])

    # decode attention: the global layer; the local layer and softcap 0
    # beside it, and the library at softcap 0 (no PyTorch call applies a
    # softcap) with K/V in its own (B, KVH, S, D) layout
    def kern(win=0, cap=cfg["softcap"]):
        return attention.decode_attention(q, k, v, lens, softcap=cap,
                                          window=win)
    kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
    mask = (torch.arange(S, device="cuda")[None, :]
            < lens[:, None])[:, None, None, :]
    def library():
        return F.scaled_dot_product_attention(q.unsqueeze(2), kt, vt,
                                              attn_mask=mask, enable_gqa=True)
    lib_diff = float((library().squeeze(2).float()
                      - kern(cap=0.0).float()).abs().max())
    a_ms, a_by = _attention_bound(q, k, lens, 0)
    ctas = attention.kernel_ctas(H, KVH, D, True, q.device)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    att_row = {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/attention.cu",
        "replaces": "src/repro/kernels/attention.py:32",
        "launches": launches["decode_attention"], "path": "ops",
        "max_abs_err": max(att_err.values()),
        "ms": _device_ms(kern, reps=50),
        "plain_ms": _device_ms(lambda: attention.decode_attention_plain(
            q, k, v, lens, softcap=cfg["softcap"]), reps=5, warm=2),
        "bound_ms": a_ms, "bound_by": a_by,
        "library_ms": _device_ms(library, reps=50),
        "library_note": "scaled_dot_product_attention(attn_mask, "
                        "enable_gqa=True) at softcap 0, K/V as (B, KVH, S, D)",
        "library_max_abs_diff_at_softcap_0": lib_diff,
        "tolerance": tol, "max_abs_err_by_layer": att_err,
        "nocap_control_excess": nocap_excess,
        "nocap_ms": _device_ms(lambda: kern(cap=0.0), reps=50),
        "local_ms": _device_ms(lambda: kern(win=cfg["window"]), reps=50),
        "local_bound_ms": _attention_bound(q, k, lens, cfg["window"])[0],
        "shape": {"B": B, "S": S, "H": H, "KVH": KVH, "D": D,
                  "dtype": "bfloat16", "lengths": lens.tolist()},
        # one wave: CTAs the SMs hold at once, each an equal run of tiles
        "ctas": ctas, "ctas_per_sm": ctas / sms,
        "smem_bytes": build.load().repro_decode_attention_smem_bytes(
            H, KVH, D, 1),
        "ptxas": _ptxas_stats(build.build()["log"], "decode_attn_kernel",
                              "13__nv_bfloat16Li256ELi2E"),
    }
    att_row["bound_share"] = att_row["bound_ms"] / att_row["ms"]
    att_row["local_bound_share"] = (att_row["local_bound_ms"]
                                    / att_row["local_ms"])
    att_row["vs_library"] = att_row["nocap_ms"] / att_row["library_ms"]
    summary = {"launches": launches, "path_s": path_s,
               "uq1_tree": tree.name, "segdegree": degrees[i_big:],
               "attention_max_abs_err": att_err,
               "attention_nocap_control_excess": nocap_excess}
    return [seg_row, att_row], summary


# wander-join batch widths: the [walks] check and timing, the online
# sampler's refinement walks (the reference's rw_batch default)
WALK_BATCH, ONLINE_RW_BATCH = 512, 256


def phase_walks(wl) -> dict:
    """Every wander-join walker of ``wl`` (UQ1 at the main path's scale):
    walks through ``probe_pick`` equal walks through its plain version on
    the same root positions and hop uniforms (rows, float32 probabilities,
    ``ok``: exact); ``probe_pick`` timed at the largest hop with one walk
    batch of real queries, beside its bound; the kernels one ``observe``
    call launches over Δ of one join and of all joins."""
    import torch
    from repro_torch.core.backends.torch_backend import PhiloxUniforms, _pack
    from repro_torch.core.estimators.torch_estimator import TorchEstimator
    from repro_torch.kernels import build, probe
    t0 = time.perf_counter()
    est = TorchEstimator(wl.cat, wl.joins, seed=0, batch=WALK_BATCH,
                         device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    stream = PhiloxUniforms(1, "cuda")
    compared = 0
    for w in est.walkers.values():
        for _ in range(2):
            r_pos, u = stream.walk(w.n_root, w.n_hops, WALK_BATCH)
            k_rows, k_prob, k_ok = w.draw(r_pos, u)
            p_rows, p_prob, p_ok = w.draw(r_pos, u, plain=True)
            _check_equal([k_rows[a] for a in w.attrs] + [k_prob, k_ok],
                         [p_rows[a] for a in w.attrs] + [p_prob, p_ok],
                         f"[walks] {w.name}")
            compared += 1
    # the largest hop of any walker, with one batch of its real queries
    w, i = max(((w, i) for w in est.walkers.values()
                for i in range(w.n_hops)),
               key=lambda t: t[0].sorted_keys[t[1]].numel())
    r_pos, u = stream.walk(w.n_root, w.n_hops, WALK_BATCH)
    rows, _, _ = w.draw(r_pos, u, plain=True)
    keys = w.sorted_keys[i]
    q = _pack(rows, w.node_edge_attrs[i], w.node_radices[i]).contiguous()
    uq = u[i].contiguous()
    kern = lambda: probe.probe_pick(keys, q, uq)                  # noqa: E731
    plain = lambda: probe.probe_pick_plain(keys, q, uq)           # noqa: E731
    a, b = kern(), plain()
    torch.cuda.synchronize()
    _check_equal(a, b, "[walks] probe_pick at the largest hop")
    bound_ms, bound_by = _bound(keys, q, pick=True)
    g = build.load().repro_probe_pick_group()
    walk_ms, events = _kernel_event_ms(kern, "probe_pick_kernel")
    width = {"walk_ms": walk_ms, "walk_profiled_events_per_call": events,
             "walk_summed_ms": _device_ms(kern),
             "walk_plain_ms": _device_ms(plain),
             "walk_call_ms": _call_ms(kern), "walk_bound_ms": bound_ms,
             "walk_bound_by": bound_by, "walk_max_abs_err": _max_abs_err(a, b),
             "walk_n_keys": keys.numel(), "walk_n_queries": q.numel(),
             "walk_levels": _search_levels(keys.numel(), g),
             "walk_node": f"{w.name}/hop {i} {w.node_edge_attrs[i]}"}
    width["walk_bound_share"] = bound_ms / width["walk_ms"]
    per_observe, observe_ms = {}, {}
    for label, delta in (("one join", wl.joins[:1]), ("all joins", wl.joins)):
        pivot = est._pivot(delta)
        per_observe[label] = _launches_per_call(
            "probe_pick", lambda: est.observe(delta))
        if per_observe[label] != est.walkers[pivot.name].n_hops:
            raise AssertionError(f"[walks] one observe over {label} launched "
                                 f"{per_observe[label]} probe_pick, not one "
                                 "per hop")
        t0 = time.perf_counter()
        for _ in range(4):
            est.observe(delta)
        torch.cuda.synchronize()
        observe_ms[label] = (time.perf_counter() - t0) / 4 * 1e3
    return {"walkers": len(est.walkers), "batches_compared": compared,
            "batch": WALK_BATCH, "walker_build_s": build_s,
            "hops": {n: w.n_hops for n, w in est.walkers.items()},
            "launches_per_observe": per_observe,
            "observe_wall_ms": observe_ms, **width}


def phase_rw_warmup(wl, hist_cover, max_walks: int) -> dict:
    """``warmup(method="random_walk", device="cuda")`` on ``wl`` and its
    cover, with the launch counts set to 0 just before and read just after
    (``probe_pick`` > 0); each join's estimated size (its accumulator at
    the end) must lie within 3 90 %-half-widths of the exact EW size."""
    import torch
    from repro_torch.core.framework import estimate_union, warmup
    from repro_torch.core.join_sampler import JoinSampler
    from repro_torch.kernels import build
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    wr = warmup(wl.cat, wl.joins, method="random_walk", seed=0,
                rw_max_walks=max_walks, device="cuda")
    est = estimate_union(wr.oracle)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(build.launch_counts)
    if launches["probe_pick"] <= 0:
        raise AssertionError("[rw-warmup] the walks launched no probe_pick")
    sizes = {}
    for j in wl.joins:
        # the accumulator after the whole warm-up (the oracle memoised the
        # size the cover used, after the first 512 walks)
        st = wr.aux.size_stats[j.name]
        exact = JoinSampler(wl.cat, j).exact_acyclic_size()
        got, hw = st.mean, st.half_width(0.90)
        sizes[j.name] = {"estimate": got, "exact": exact, "half_width_90": hw,
                         "walks": st.count,
                         "cover_estimate": wr.oracle.size(j.name)}
        if not abs(got - exact) <= 3 * hw:
            raise AssertionError(f"[rw-warmup] {j.name}: estimate {got} is "
                                 f"more than 3 half-widths ({hw}) from the "
                                 f"exact size {exact}")
    ostats = wr.aux.overlap_stats
    return {"seconds": seconds, "rw_max_walks": max_walks,
            "sizes": sizes,
            "piece_sizes": {n: est.cover.piece_sizes[n]
                            for n in est.cover.order},
            "histogram_piece_sizes": {n: hist_cover.piece_sizes[n]
                                      for n in hist_cover.order},
            "union_size_cover": est.union_size_cover,
            "overlap_terms": sum(len(k) > 1 for k in ostats),
            # each walk batch feeds exactly one Δ accumulator
            "walks": sum(st.count for st in ostats.values()),
            "launches": launches}


class _Timer:
    """Calls and seconds of a wrapped callable (synchronised on exit)."""

    def __init__(self, fn):
        self.fn, self.calls, self.seconds = fn, 0, 0.0

    def __call__(self, *a, **kw):
        import torch
        t0 = time.perf_counter()
        try:
            return self.fn(*a, **kw)
        finally:
            torch.cuda.synchronize()
            self.calls += 1
            self.seconds += time.perf_counter() - t0


def phase_online(wl, calls) -> dict:
    """``OnlineUnionSampler(backend="torch", device="cuda", phi=256,
    rw_batch=256)`` on ``wl``: ``sample(n)`` for each n of ``calls``
    (the accepted list is cumulative, as in the reference, so each call
    draws the rows past the last one), with the launch counts set to 0 just
    before the sampler is built and read after the last call; launches
    inside the estimator's ``observe`` are the walks', the rest the
    candidate draws'.  Every row lies in its home piece and no earlier one."""
    import torch
    from repro_torch.core.estimators.torch_estimator import TorchEstimator
    from repro_torch.core.online import OnlineUnionSampler
    from repro_torch.kernels import build
    walk_launches = {"probe_pick": 0, "sorted_probe": 0}
    observe = TorchEstimator.observe

    def counted(self, *a, **kw):
        before = dict(build.launch_counts)
        try:
            return observe(self, *a, **kw)
        finally:
            for k in walk_launches:
                walk_launches[k] += build.launch_counts[k] - before[k]
    torch.cuda.synchronize()
    build.reset_launch_counts()
    TorchEstimator.observe = counted
    try:
        t0 = time.perf_counter()
        s = OnlineUnionSampler(wl.cat, wl.joins, seed=0, backend="torch",
                               device="cuda", phi=256,
                               rw_batch=ONLINE_RW_BATCH)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        refresh = s._refresh_parameters = _Timer(s._refresh_parameters)
        contains = _Timer(s.prober.contains)
        s.prober.contains = contains
        refills = []
        for src in s.sources.values():
            src._refill = _Timer(src._refill)
            refills.append(src._refill)
        per_call, have = [], 0
        for n in calls:
            t0 = time.perf_counter()
            ss = s.sample(n)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            per_call.append({"n": n, "new_rows": n - have, "seconds": dt,
                             "samples_per_s": (n - have) / dt})
            have = n
    finally:
        TorchEstimator.observe = observe
    launches = dict(build.launch_counts)
    draws = {k: launches[k] - walk_launches[k] for k in walk_launches}
    if walk_launches["probe_pick"] <= 0:
        raise AssertionError("[online] the walks launched no probe_pick")
    if draws["probe_pick"] <= 0 or draws["sorted_probe"] <= 0:
        raise AssertionError(f"[online] the candidate draws launched {draws}")
    check_membership(s, ss.rows, ss.home)
    # one per-candidate membership probe: device ops and time
    rows1 = {a: ss.rows[a][:1] for a in s.attrs}
    probe_one = lambda: s.prober.contains(s.order[0], rows1)      # noqa: E731
    ev = _device_events(probe_one, 20)
    st = s.stats
    sample_s = sum(c["seconds"] for c in per_call)
    return {
        "calls": per_call, "init_s": init_s, "sample_s": sample_s,
        "refresh_s": refresh.seconds, "refreshes": s.refresh_count,
        "membership_probe_s": contains.seconds,
        "membership_probe_calls": contains.calls,
        "source_refill_s": sum(r.seconds for r in refills),
        "source_refills": sum(r.calls for r in refills),
        "membership_probe_wall_ms": contains.seconds / max(contains.calls, 1)
        * 1e3,
        "membership_probe_device_ops": len(ev) / 20,
        "membership_probe_device_ms": sum(us for _, us in ev) / 20 / 1e3,
        "psi": st.psi(), "candidate_draws": st.candidate_draws,
        "iterations": st.iterations, "reuse_accepts": st.reuse_accepts,
        "reuse_rejects": st.reuse_rejects, "cover_rejects": st.cover_rejects,
        "dropped_slots": st.dropped_slots,
        "backtrack_removed": st.backtrack_removed,
        "walks_in_size_accumulators": sum(
            v.count for v in s.estimator.size_stats.values()),
        "home_counts": np.bincount(ss.home, minlength=len(s.order)).tolist(),
        "order": s.order,
        "init_piece_sizes": s.trace.events("init")[0]["piece_sizes"],
        "piece_sizes": {n: s.cover.piece_sizes[n] for n in s.order},
        "last_hist_gap": (s.trace.last("refresh") or {}).get("hist_gap"),
        "launches": launches, "walk_launches": walk_launches,
        "draw_launches": draws, "rows_in_home_piece_only": True}


def phase_online_reference(seed: int = 0) -> dict:
    """ONLINE UQ1 at scale 0.05 (overlap 0.4) on the card, held to the
    reference's bar for Algorithm 2 (``tests/test_union.py``
    ``test_online_union_end_to_end``): ``sample(40·U)`` covers at least
    0.9·U distinct rows, no row comes more than 12× the mean, reuse
    accepted rows; and every row lies in its home piece only.  Online
    output is uniform only under the refined parameters, so no strict
    chi-square."""
    from repro_torch.core.online import OnlineUnionSampler
    from repro_torch.core.overlap import exact_union_size
    from repro_torch.data.workloads import uq1
    wl = uq1(scale=0.05, overlap=0.4, seed=seed)
    U = exact_union_size(wl.cat, wl.joins)
    t0 = time.perf_counter()
    s = OnlineUnionSampler(wl.cat, wl.joins, seed=12, phi=512, rw_batch=128,
                           device="cuda")
    ss = s.sample(40 * U)
    dt = time.perf_counter() - t0
    m = ss.matrix()
    uni, counts = np.unique(m.view([("", m.dtype)] * m.shape[1]).ravel(),
                            return_counts=True)
    out = {"U": U, "samples": len(ss), "distinct": int(uni.shape[0]),
           "max_over_mean": float(counts.max() / counts.mean()),
           "reuse_accepts": ss.stats.reuse_accepts,
           "iterations": ss.stats.iterations,
           "dropped_slots": ss.stats.dropped_slots,
           "piece_sizes": {n: s.cover.piece_sizes[n] for n in s.order},
           "refreshes": s.refresh_count, "seconds": dt}
    if not (len(ss) == 40 * U and uni.shape[0] >= 0.9 * U
            and counts.max() <= 12 * counts.mean()
            and ss.stats.reuse_accepts > 0):
        raise AssertionError(f"[reference] online UQ1 misses the bar: {out}")
    check_membership(s, ss.rows, ss.home)
    return out


def phase_small_reference(workload: str = "UQ1", seed: int = 0,
                          **kw) -> float:
    """UQ1 at scale 0.05 (overlap 0.4) or UQ2 at scale 0.05: the card's
    samples are uniform over the exact union (chi-square p-value returned;
    must exceed 1e-3).  ``kw`` goes to ``SetUnionSampler`` (``plan``,
    ``membership``) or, as ``pred_mode``, to UQ2."""
    from repro_torch.core.framework import estimate_union, warmup
    from repro_torch.core.overlap import exact_union_size
    from repro_torch.core.union_sampler import SetUnionSampler
    from repro_torch.data.workloads import uq1, uq2
    if workload == "UQ1":
        wl = uq1(scale=0.05, overlap=0.4, seed=seed)
    else:
        wl = uq2(scale=0.05, seed=seed,
                 pred_mode=kw.pop("pred_mode", "pushdown"))
    est = estimate_union(warmup(wl.cat, wl.joins, method="exact").oracle)
    U = exact_union_size(wl.cat, wl.joins)
    s = SetUnionSampler(wl.cat, wl.joins, est.cover, seed=7, device="cuda",
                        round_batch=1024, **kw)
    ss = s.sample(200 * U)
    p = _chi2_p(ss.matrix(), U)
    # strict homes in record mode too: at N = 200·U every tuple's first
    # piece has drawn it before the call settles
    check_membership(s, ss.rows, ss.home)
    if p <= 1e-3:
        raise AssertionError(f"{workload} {kw} small-input chi-square failed "
                             f"(p={p})")
    return p


def _launches() -> dict:
    """The shared kernel launch counts, after a device synchronise."""
    import torch
    from repro_torch.kernels import build
    torch.cuda.synchronize()
    return dict(build.launch_counts)


def _require_probes(label: str, launches: dict) -> None:
    for k in ("sorted_probe", "probe_pick"):
        if launches[k] <= 0:
            raise AssertionError(f"[{label}] kernel {k} was not launched")


def _check_homes(label: str, joins, rows, home, canonical: bool) -> None:
    """Each row lies in its home join and, if ``canonical``, in no earlier
    join (host lookups in the base relations, sharing no code with the
    engine)."""
    mm = _join_membership(joins, rows)
    if not mm[np.arange(home.size), home].all():
        raise AssertionError(f"[{label}] a row is not in its home join")
    if canonical and not np.array_equal(np.argmax(mm, axis=1), home):
        raise AssertionError(f"[{label}] a row is credited to a later join "
                             "than its first")


def _chi2_p(mat, U) -> float:
    """Chi-square p-value of ``mat``'s rows against the uniform law over a
    union of ``U`` tuples (raises on a tuple outside it)."""
    from scipy import stats as sps
    uni, counts = np.unique(mat.view([("", mat.dtype)] * mat.shape[1]).ravel(),
                            return_counts=True)
    if uni.shape[0] > U:
        raise AssertionError("sampled tuples outside the union")
    exp = mat.shape[0] / U
    chi2 = float(((counts - exp) ** 2 / exp).sum()) + (U - uni.shape[0]) * exp
    return float(1 - sps.chi2.cdf(chi2, df=U - 1))


def phase_baselines(wl, union_estimate: float, backend) -> dict:
    """The paper's baselines on ``wl`` (on ``backend``, a ``TorchBackend``
    built once for this phase and the next ones): ``DisjointUnionSampler.sample(65536)``
    over the exact EW join sizes (rows in their home join; home shares
    within 6σ + 0.002 of ``|J_j|/Σ|J|``) and ``BernoulliUnionSampler.
    sample(8192)`` over those sizes and the random-walk union estimate
    (rows in their home join and in no earlier one), each with the launch
    counts set to 0 just before its call and read just after (both probes
    > 0).  Then Bernoulli at UQ1 scale 0.05 against the reference's bar:
    80·U rows, chi-square p > 1e-3 over the exact union."""
    import torch
    from repro_torch.core.framework import warmup
    from repro_torch.core.join_sampler import JoinSampler
    from repro_torch.core.overlap import exact_union_size
    from repro_torch.core.union_sampler import (BernoulliUnionSampler,
                                                DisjointUnionSampler)
    from repro_torch.data.workloads import uq1
    from repro_torch.kernels import build
    sizes = {j.name: JoinSampler(wl.cat, j).exact_acyclic_size()
             for j in wl.joins}
    out = {"join_sizes": sizes, "union_estimate": union_estimate}
    # Bernoulli first: the samplers share the backend's candidate sources,
    # and Disjoint's last refills would serve Bernoulli's draws
    for label, cls, args, n in (
            ("bernoulli", BernoulliUnionSampler, (sizes, union_estimate),
             8192),
            ("disjoint", DisjointUnionSampler, (sizes,), 65536)):
        smp = cls(wl.cat, wl.joins, *args, backend=backend)
        if label == "bernoulli":
            # the canonical test: one host-synced oracle probe per fired
            # join and earlier join, each round
            oracle = smp.prober.contains = _Timer(smp.prober.contains)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        ss = smp.sample(n)
        dt = time.perf_counter() - t0
        launches = _launches()
        _require_probes(label, launches)
        if len(ss) != n:
            raise AssertionError(f"[baselines] {label} gave {len(ss)} rows")
        t0 = time.perf_counter()
        _check_homes(label, wl.joins, ss.rows, ss.home,
                     canonical=label == "bernoulli")
        st = ss.stats
        out[label] = {"samples": n, "seconds": dt,
                      "samples_per_s": n / dt, "psi": st.psi(),
                      "candidate_draws": st.candidate_draws,
                      "canonical_rejects": st.canonical_rejects,
                      "home_counts": np.bincount(
                          ss.home, minlength=len(wl.joins)).tolist(),
                      "membership_check_s": time.perf_counter() - t0,
                      "launches": launches}
        if label == "disjoint":
            p = np.array([sizes[j.name] for j in wl.joins], np.float64)
            p /= p.sum()
            f = np.bincount(ss.home, minlength=p.size) / n
            tol = 6 * np.sqrt(p * (1 - p) / n) + 0.002
            if not (np.abs(f - p) <= tol).all():
                raise AssertionError(f"[baselines] disjoint home shares {f} "
                                     f"differ from {p} (tol {tol})")
        else:
            out[label].update(rounds=st.iterations // 256,
                              oracle_calls=oracle.calls,
                              oracle_s=oracle.seconds,
                              oracle_wall_ms=oracle.seconds
                              / max(oracle.calls, 1) * 1e3)
            if st.canonical_rejects <= 0:
                raise AssertionError("[baselines] Bernoulli rejected nothing")
    # the reference's bar for Bernoulli, at a size with an exact union
    small = uq1(scale=0.05, overlap=0.4, seed=0)
    wr = warmup(small.cat, small.joins, method="exact")
    ssz = {j.name: wr.oracle.size(j.name) for j in small.joins}
    U = exact_union_size(small.cat, small.joins)
    t0 = time.perf_counter()
    bern = BernoulliUnionSampler(small.cat, small.joins, ssz, float(U),
                                 seed=9, device="cuda")
    ss = bern.sample(80 * U)
    p = _chi2_p(ss.matrix(), U)
    _check_homes("bernoulli 0.05", small.joins, ss.rows, ss.home, True)
    out["bernoulli_reference"] = {"U": U, "samples": len(ss), "chi2_p": p,
                                  "seconds": time.perf_counter() - t0}
    if p <= 1e-3:
        raise AssertionError(f"[baselines] Bernoulli at scale 0.05 is not "
                             f"uniform (p={p})")
    return out


def phase_chain(wl, n: int = 65536) -> dict:
    """``TorchChainSampler`` over UQ1_J0: kernel draws equal plain draws on
    the same uniforms, then the rate of ``sample_uniform(n)`` with the
    launch counts set to 0 just before and read just after; its rows lie in
    the join."""
    import torch
    from repro_torch.core.torch_sampler import TorchChainSampler
    from repro_torch.kernels import build
    spec = wl.joins[0]
    t0 = time.perf_counter()
    cs = TorchChainSampler(wl.cat, spec, seed=0, device="cuda")
    build_s = time.perf_counter() - t0
    u = cs.uniforms.tree(cs.tree.n_streams, 8192)
    a, b = cs.tree.draw(u), cs.tree.draw(u, plain=True)
    _check_equal([a[1], a[2]] + [a[0][k] for k in cs.attrs],
                 [b[1], b[2]] + [b[0][k] for k in cs.attrs],
                 f"[chain] {spec.name} draws")
    cs.sample_uniform(4096)                          # warm-up
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    rows = cs.sample_uniform(n)
    dt = time.perf_counter() - t0
    launches = _launches()
    _require_probes("chain", launches)
    head = {k: v[:4096] for k, v in rows.items()}
    if not _join_membership([spec], head).all():
        raise AssertionError("[chain] a row is not in the join")
    return {"join": spec.name, "hops": cs.n_hops, "build_s": build_s,
            "samples": n, "seconds": dt, "samples_per_s": n / dt,
            "draws_kernel_eq_plain": 8192, "launches": launches}


def phase_replicas(wl, est, round_batch: int, backend, requests: int = 8,
                   samples: int = 4096) -> dict:
    """Two ``seed-split`` replicas (world 2, ranks 0 and 1), each warmed by
    one call of the batch size (its capture, reported apart), served through
    one ``SampleService`` (``requests`` × ``samples``, launch counts set to
    0 just before and read just after; rows in their home piece and no
    earlier one), a ``hash-partition`` rank 0 of 2 (every row in partition
    0), and ``merge_streams`` of the replicas' next samples."""
    import torch
    from repro_torch.core.distributed import (DistributedUnionSampler,
                                              merge_streams, partition_of)
    from repro_torch.kernels import build
    from repro_torch.serve import SampleService
    reps = [DistributedUnionSampler(wl.cat, wl.joins, est.cover, rank=r,
                                    world=2, seed=0, backend=backend,
                                    round_batch=round_batch)
            for r in range(2)]
    # each replica's batch class is captured before the timed window, as
    # serve() warms a single sampler: the rate is steady-state serving
    for r in reps:
        r.sample(round_batch)
    capture_s = [r.inner.engine.capture_seconds for r in reps]
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    with SampleService(reps, batch=round_batch, prefetch=2) as svc:
        got = [svc.request(samples) for _ in range(requests)]
        merged_stats = svc.stats()
    dt = time.perf_counter() - t0
    launches = _launches()
    _require_probes("replicas", launches)
    if [len(g) for g in got] != [samples] * requests:
        raise AssertionError("[replicas] short responses")
    check_membership(reps[0].inner, got[-1].rows, got[-1].home)
    hp = DistributedUnionSampler(wl.cat, wl.joins, est.cover, rank=0,
                                 world=2, scheme="hash-partition", seed=0,
                                 backend=backend, round_batch=round_batch)
    ss = hp.sample(samples)
    if len(ss) != samples or not (partition_of(ss.fingerprint, 2) == 0).all():
        raise AssertionError("[replicas] hash-partition rank 0 left its "
                             "partition")
    check_membership(hp.inner, ss.rows, ss.home)
    parts = [r.sample(samples) for r in reps]
    merged = merge_streams(parts, seed=0)
    if len(merged) != 2 * samples or merged.stats.samples_emitted != sum(
            p.stats.samples_emitted for p in parts):
        raise AssertionError("[replicas] merge_streams lost rows or counts")
    return {"requests": requests, "samples": samples,
            "seconds": dt, "samples_per_s": requests * samples / dt,
            "capture_s": [{str(C): t for C, t in sorted(c.items())}
                          for c in capture_s],
            "psi": merged_stats.psi(), "launches": launches,
            "hash_partition_rows": len(ss),
            "hash_partition_psi": ss.stats.psi(), "merged_rows": len(merged)}


def phase_sharded(wl, est, round_batch: int, backend, calls: int = 3,
                  n: int = 8192) -> dict:
    """World 1 on ``wl`` (no process group, no collective):
    ``SetUnionSampler(mesh=make_sampler_mesh(world=1))`` and, on the same
    ``ShardedCatalog``, the adaptive ``ShardedUnionSampler``; each against
    the unsharded engine with the same seed on the same backend (the engine
    a ``SetUnionSampler`` without a mesh runs, in its host loop, the
    sharded engine's only mode): ``calls`` × ``sample(n)``
    bit-equal in rows, homes, fingerprints and ``SamplerStats``, with the
    launch counts set to 0 just before the sharded calls and read just
    after.  Then both engines' rates in turns on one state."""
    import torch
    from repro_torch.core.backends.torch_backend import TorchUnionSampler
    from repro_torch.core.sharding import ShardedUnionSampler, \
        make_sampler_mesh
    from repro_torch.core.union_sampler import SamplerStats, SetUnionSampler
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    meshed = SetUnionSampler(wl.cat, wl.joins, est.cover, seed=0,
                             backend=backend, round_batch=round_batch,
                             mesh=make_sampler_mesh(world=1))
    torch.cuda.synchronize()
    out = {"sharded_catalog_build_s": time.perf_counter() - t0,
           "device": str(meshed.device)}
    scat = meshed.engine.scat
    for plan in ("static", "adaptive"):
        sharded = (meshed.engine if plan == "static" else ShardedUnionSampler(
            scat, est.cover, seed=0, round_batch=round_batch,
            stats=SamplerStats(), plan=plan))
        # the unsharded host loop: the sharded engine's own loop mode
        plain = TorchUnionSampler(meshed.backend, est.cover, seed=0,
                                  round_batch=round_batch,
                                  stats=SamplerStats(), plan=plan,
                                  fused_rounds="host")
        torch.cuda.synchronize()
        build.reset_launch_counts()
        got = [sharded.sample(n) for _ in range(calls)]
        launches = _launches()
        _require_probes(f"sharded {plan}", launches)
        want = [plain.sample(n) for _ in range(calls)]
        # (a SampleSet's stats are the engine's running counters)
        if not (all(np.array_equal(a.matrix(), b.matrix())
                    and np.array_equal(a.home, b.home)
                    and np.array_equal(a.fingerprint, b.fingerprint)
                    for a, b in zip(got, want))
                and got[-1].stats.as_dict() == want[-1].stats.as_dict()):
            raise AssertionError(f"[sharded] {plan}: world 1 differs from "
                                 "the unsharded engine")
        check_membership(meshed, got[-1].rows, got[-1].home)

        def rate(engine, k=4):
            t0 = time.perf_counter()
            for _ in range(k):
                engine.sample(round_batch)
            torch.cuda.synchronize()
            return k * round_batch / (time.perf_counter() - t0)
        out[plan] = {"calls": calls, "n": n, "bit_equal": True,
                     "launches": launches,
                     "shard_piece_batches": list(sharded.shard_piece_batches),
                     "psi": got[-1].stats.psi(),
                     "engine_samples_per_s_in_turns": [
                         [name, rate(e)] for name, e in (
                             ("unsharded", plain), ("sharded", sharded),
                             ("sharded", sharded), ("unsharded", plain))]}
    return out


def phase_sharded_est(wl, rw_out: dict, max_walks: int) -> dict:
    """``warmup(method="random_walk", mesh=world 1)`` with ``[rw-warmup]``'s
    seed and budget equals that warm-up: per join the estimate, its 90 %
    half-width and its walk count, and the union size of the cover."""
    from repro_torch.core.framework import estimate_union, warmup
    from repro_torch.core.sharding import make_sampler_mesh
    from repro_torch.kernels import build
    build.reset_launch_counts()
    t0 = time.perf_counter()
    wr = warmup(wl.cat, wl.joins, method="random_walk", seed=0,
                rw_max_walks=max_walks, mesh=make_sampler_mesh(world=1))
    est = estimate_union(wr.oracle)
    launches = _launches()
    seconds = time.perf_counter() - t0
    if launches["probe_pick"] <= 0:
        raise AssertionError("[sharded-est] the walks launched no probe_pick")
    for j in wl.joins:
        st, want = wr.aux.size_stats[j.name], rw_out["sizes"][j.name]
        got = {"estimate": st.mean, "half_width_90": st.half_width(0.90),
               "walks": st.count}
        if any(got[k] != want[k] for k in got):
            raise AssertionError(f"[sharded-est] {j.name}: {got} differs "
                                 f"from the warm-up without a mesh {want}")
    if est.union_size_cover != rw_out["union_size_cover"]:
        raise AssertionError("[sharded-est] the cover's union size differs")
    return {"seconds": seconds, "equal_to_rw_warmup": True,
            "union_size_cover": est.union_size_cover, "launches": launches}


def _w2_rank(rank: int, port: int, scale: float, requests: int,
             samples: int, round_batch: int, results) -> None:
    """One rank of ``[sharded-w2]``: the serve CLI's sampler with
    ``shards=2`` over a gloo group on the one card."""
    import datetime
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        import hashlib
        from repro_torch.kernels import build
        from repro_torch.launch.serve import build_sampler
        sampler, _, _, _ = build_sampler("UQ1", scale, seed=0, device="cuda",
                                         round_batch=round_batch, shards=2)
        sampler.sample(256)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        got = [sampler.sample(samples) for _ in range(requests)]
        dt = time.perf_counter() - t0
        launches = _launches()
        mat = np.concatenate([np.concatenate([g.matrix(), g.home[:, None]],
                                             axis=1) for g in got])
        last = got[-1]
        check_membership(sampler, last.rows, last.home)
        results.put((rank, {"seconds": dt,
                            "samples_per_s": requests * samples / dt,
                            "launches": launches, "rows": mat.shape[0],
                            "digest": hashlib.sha256(np.ascontiguousarray(
                                mat, np.int64).tobytes()).hexdigest(),
                            "device": str(sampler.device)}))
    except BaseException as e:
        results.put((rank, {"error": repr(e)}))
        raise
    finally:
        dist.destroy_process_group()


def phase_sharded_w2(scale: float, round_batch: int, requests: int = 4,
                     samples: int = 4096, timeout: float = 150.0) -> dict:
    """Two processes on the one card in a gloo group (NCCL refuses two
    ranks on one device): UQ1 at ``scale`` with ``shards=2``, ``requests``
    × ``sample(samples)`` on each rank.  Both ranks must return the same
    rows (a digest of the whole stream) with their rows in their home
    pieces, and both probes must launch on each."""
    import socket
    import torch.multiprocessing as mp
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_w2_rank, args=(r, port, scale, requests,
                                                samples, round_batch,
                                                results))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, res = results.get(timeout=timeout)
            got[rank] = res
    finally:
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join(5)
    if any(p.exitcode != 0 or "error" in got.get(r, {"error": None})
           for r, p in enumerate(procs)):
        raise AssertionError(f"[sharded-w2] ranks failed: exit codes "
                             f"{[p.exitcode for p in procs]}, {got}")
    if got[0]["digest"] != got[1]["digest"] or got[0]["rows"] != \
            requests * samples:
        raise AssertionError(f"[sharded-w2] the ranks' streams differ: {got}")
    for r in got.values():
        _require_probes("sharded-w2", r["launches"])
    return {"scale": scale, "world": 2, "backend": "gloo",
            "requests": requests, "samples": samples,
            "wall_s": time.perf_counter() - t0, "ranks": got}


def _mode_parity(label: str, wl, est, round_batch: int, calls, backend,
                 plan: str = "static"):
    """``fused_rounds="device"`` and ``"host"`` samplers from one seed on
    ``backend``, over ``calls``: bit-equal rows, homes, ``SamplerStats``,
    per-piece counters and, at the end, the carry (banks, shortfall, dead
    flags, streaks, EMAs) and the Philox offset.  Every device-mode call
    makes its chunks' syncs plus one fetch.  Returns the per-call rounds,
    chunks, host syncs and wasted rounds, the capture seconds per class,
    and the two samplers."""
    import torch
    from repro_torch.core.union_sampler import SetUnionSampler
    dev, host = (SetUnionSampler(wl.cat, wl.joins, est.cover, seed=5,
                                 backend=backend, device="cuda",
                                 round_batch=round_batch, plan=plan,
                                 fused_rounds=m) for m in ("device", "host"))
    per_call = []
    for n in calls:
        a, b = dev.sample(n), host.sample(n)
        same = (all(np.array_equal(a.rows[x], b.rows[x]) for x in a.attrs)
                and np.array_equal(a.home, b.home)
                and np.array_equal(a.fingerprint, b.fingerprint)
                and dev.stats.as_dict() == host.stats.as_dict()
                and np.array_equal(dev.engine.piece_stats,
                                   host.engine.piece_stats))
        if not same:
            raise AssertionError(f"[{label}] {plan}: the device loop differs "
                                 f"from the host loop at sample({n})")
        e = dev.engine
        if e.last_host_syncs != e.last_chunks + 1:
            raise AssertionError(f"[{label}] {e.last_host_syncs} host syncs "
                                 f"for {e.last_chunks} chunks")
        per_call.append({"n": n, "rounds": e.last_rounds,
                         "chunks": e.last_chunks,
                         "host_syncs": e.last_host_syncs,
                         "wasted_rounds": e.last_wasted_rounds,
                         "host_loop_syncs": host.engine.last_host_syncs})
    sd, sh = dev.engine._state, host.engine._state
    for f in ("owed", "dead", "streak", "head", "count", "ema"):
        x, y = getattr(sd, f), getattr(sh, f)
        if x is not None and not torch.equal(x, y):
            raise AssertionError(f"[{label}] {plan}: carry {f} differs")
    if not torch.equal(sd.bank[:, :-1], sh.bank[:, :-1]):
        raise AssertionError(f"[{label}] {plan}: the banks differ")
    if (dev.engine.uniforms.generator.get_offset()
            != host.engine.uniforms.generator.get_offset()):
        raise AssertionError(f"[{label}] {plan}: the Philox streams differ")
    return {"plan": plan, "bit_equal": True, "calls": per_call,
            "capture_s": {str(C): s for C, s in
                          sorted(dev.engine.capture_seconds.items())}
            }, dev, host


# the probe kernels' event names in a profiler trace, by launch-count key
PROBE_EVENTS = (("sorted_probe", "sorted_probe_kernel"),
                ("probe_pick", "probe_pick_kernel"))


def _replay_events(label: str, dev, n: int, required) -> dict:
    """One device-mode ``dev.sample(n)`` under the profiler, its capacity
    class already captured, so its probes run only inside graph replays:
    each probe's kernel events must equal exactly the launches recorded in
    one captured round × the rounds replayed, and each kernel in
    ``required`` must be among them."""
    eng = dev.engine
    C = 1 << max(10, (n - 1).bit_length())
    if C not in eng.capture_seconds:
        raise AssertionError(f"[{label}] class {C} was not captured before "
                             "the profiled call")
    ev = _device_events(lambda: dev.sample(n), 1)
    replays = eng.last_rounds + eng.last_wasted_rounds
    per_round = eng._buffers[C].replay_launches
    seen = {kern: sum(1 for name, _ in ev if match in name)
            for kern, match in PROBE_EVENTS}
    want = {kern: per_round[kern] * replays for kern, _ in PROBE_EVENTS}
    if seen != want or not all(want[k] > 0 for k in required):
        raise AssertionError(f"[{label}] kernel events {seen} in a call of "
                             f"{replays} graph replays of {per_round}")
    return {"plan": eng.plan, "graph_replays": replays,
            "kernel_events": seen, "launches_per_replay": per_round,
            "device_events": len(ev)}


# the device loop's parity calls: 8192 and odd sizes that leave its
# capacity class (8192 → 16384 → 4096) and come back
DEVICE_LOOP_CALLS = (8192, 5000, 12000, 8192, 3333)


def phase_device_loop(wl, est, round_batch: int, backend) -> dict:
    """``[device-loop]`` on UQ1: both plans' device loop bit-equal to the
    host loop (:func:`_mode_parity`) and, in one more device-mode call of
    each plan, the probe kernel events of its graph replays equal to the
    launches counted (:func:`_replay_events`); under the static plan, the
    launch counts of device-mode calls (set to 0 just before, read just
    after), the two modes' engine rates in turns, and each mode's
    ``[profile]`` split with its device busy share."""
    import torch
    from repro_torch.kernels import build
    out = {}
    for plan in ("static", "adaptive"):
        out[plan], dev, host = _mode_parity(
            "device-loop", wl, est, round_batch, DEVICE_LOOP_CALLS, backend,
            plan=plan)
        out[plan]["replay"] = _replay_events(
            "device-loop", dev, round_batch, ("sorted_probe", "probe_pick"))
        if plan != "static":
            continue
        n = round_batch

        def rate(smp, k=4):
            t0 = time.perf_counter()
            for _ in range(k):
                smp.sample(n)
            torch.cuda.synchronize()
            return k * n / (time.perf_counter() - t0)
        dev.sample(n)
        host.sample(n)
        rates = [["device", rate(dev)], ["host", rate(host)],
                 ["host", rate(host)]]
        build.reset_launch_counts()
        rates.append(["device", rate(dev)])
        out["launches"] = _launches()           # the device-mode calls only
        _require_probes("device-loop", out["launches"])
        out["engine_samples_per_s_in_turns"] = rates
        dev_rate, host_rate = ((rates[0][1] + rates[3][1]) / 2,
                               (rates[1][1] + rates[2][1]) / 2)
        out["profile_device"] = phase_profile(dev, n, n / dev_rate)
        out["profile_host"] = phase_profile(host, n, n / host_rate)
    return out


def _scrape(url: str):
    import urllib.request
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, r.read().decode()


def _series(text: str) -> dict:
    """Prometheus text → ``{"name{labels}": value}``."""
    out = {}
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            key, val = ln.rsplit(" ", 1)
            out[key] = float(val)
    return out


def phase_metrics(wl, est, round_batch: int, backend, requests: int = 8,
                  samples: int = 4096) -> dict:
    """``[metrics]``: a device-loop UQ1 sampler, its batch class captured
    by one call first, served through ``SampleService`` with a ``MetricsServer`` on an ephemeral port, on a
    registry of its own.  ``/healthz`` and ``/metrics`` are scraped over
    localhost while the service is live (the engine and serve series under
    the reference's names, the request count), then ``/metrics`` again
    after the service stops (its producer quiesced): every engine series
    equals the engine's own counters and every serve series the requests
    made."""
    from repro_torch import obs
    from repro_torch.core.union_sampler import SetUnionSampler
    from repro_torch.serve import SampleService
    reg = obs.MetricsRegistry()
    prev = obs.set_registry(reg)
    try:
        s = SetUnionSampler(wl.cat, wl.joins, est.cover, seed=9,
                            backend=backend, device="cuda",
                            round_batch=round_batch)
        s.sample(round_batch)       # capture the batch class before serving
        with obs.MetricsServer(reg, port=0) as srv:
            t0 = time.perf_counter()
            with SampleService(s, batch=round_batch, prefetch=2) as svc:
                for _ in range(requests):
                    svc.request(samples)
                health = _scrape(srv.url + "/healthz")
                live_status, live_text = _scrape(srv.url + "/metrics")
            dt = time.perf_counter() - t0
            _, text = _scrape(srv.url + "/metrics")
            port = srv.port
    finally:
        obs.set_registry(prev)
    live = _series(live_text)
    if health != (200, "ok\n") or live_status != 200:
        raise AssertionError(f"[metrics] /healthz {health}, /metrics "
                             f"{live_status}")
    names = ("repro_engine_piece_draws_total", "repro_engine_rounds_total",
             "repro_engine_samples_total", "repro_engine_piece_bank_hwm",
             "repro_round_waste_ratio", "repro_engine_dispatch_seconds",
             "repro_engine_drain_seconds", "repro_serve_request_seconds",
             "repro_serve_requests_total", "repro_serve_samples_total",
             "repro_serve_queue_depth", "repro_serve_request_seconds_p99",
             "repro_serve_engine_stat")
    missing = [m for m in names if f"# TYPE {m} " not in live_text]
    if missing or live["repro_serve_requests_total"] != requests:
        raise AssertionError(f"[metrics] live scrape: missing {missing}, "
                             f"requests {live.get('repro_serve_requests_total')}")
    got = _series(text)
    eng, st = s.engine, s.stats
    want = {"repro_engine_rounds_total": eng.total_rounds,
            "repro_engine_samples_total": st.samples_emitted,
            "repro_serve_requests_total": requests,
            "repro_serve_samples_total": requests * samples,
            'repro_serve_engine_stat{replica="0",field="candidate_draws"}':
                st.candidate_draws,
            'repro_serve_engine_stat{replica="0",field="iterations"}':
                st.iterations}
    for j, name in enumerate(eng.order):
        for i, m in enumerate(("draws", "accepts", "residual_rejects",
                               "bank_drained")):
            key = f'repro_engine_piece_{m}_total{{join="{name}"}}'
            if eng.piece_stats[j, i] or key in got:
                want[key] = int(eng.piece_stats[j, i])
        want[f'repro_engine_piece_bank_hwm{{join="{name}"}}'] = \
            int(eng.piece_stats[j, 4])
    bad = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if bad:
        raise AssertionError(f"[metrics] series differ from the engine's "
                             f"counters: {bad}")
    return {"port": port, "requests": requests, "samples": samples,
            "seconds": dt, "healthz": health[1].strip(),
            "series_checked": len(want), "series_total": len(got),
            "engine_rounds_total": eng.total_rounds,
            "engine_samples_total": st.samples_emitted,
            "host_syncs": eng.host_syncs,
            "capture_s": {str(C): t for C, t in
                          sorted(eng.capture_seconds.items())},
            "request_p50_s": got.get("repro_serve_request_seconds_p50"),
            "request_p99_s": got.get("repro_serve_request_seconds_p99")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=UQ1_SCALE,
                    help="UQ1 scale (100 ≈ TPC-H SF 1)")
    ap.add_argument("--uq4-scale", type=float, default=UQ4_SCALE)
    ap.add_argument("--round-batch", type=int, default=8192)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--online-samples", type=int, default=ONLINE_SAMPLES_RUN,
                    help="rows of each of [online]'s two sample() calls")
    ap.add_argument("--rw-max-walks", type=int, default=RW_MAX_WALKS,
                    help="[rw-warmup]'s walk budget per overlap term")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from repro_torch.kernels import build

    # full fp32 in the plain versions' products (the comparison targets)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # wall seconds of each phase, printed on the [phases] line
    marks = [("start", time.perf_counter())]

    def mark(label):
        marks.append((label, time.perf_counter()))

    # 1. device and build (one library holds every kernel)
    card = _card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}",
          flush=True)
    info = build.build()
    build.load()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    print(f"[build] {info['path']} in {info['seconds']:.2f}s "
          f"(cached={info['cached']})", flush=True)
    for ln in ptxas:
        print(f"[build] {ln}", flush=True)

    # 2. kernels at edge shapes
    n_cases = phase_edge_sweeps()
    print(f"[kernels] {n_cases} edge sweeps: kernel == plain (exact)",
          flush=True)
    mark("build + edge sweeps")

    rows: list = []

    def kernels_and_parity(sampler):
        rows.extend(phase_kernels(sampler))
        n = phase_draw_parity(sampler, sampler.engine.piece_batches[0])
        print(f"[parity] {n} UQ1 draws: kernels == plain versions (exact)",
              flush=True)

    # 3.+4. main path; kernel timing and draw parity run on its state first
    main_out = run_path("main", "UQ1", args.scale, args.requests, args.samples,
                        args.round_batch, ("sorted_probe", "probe_pick"),
                        before_serve=kernels_and_parity)
    main_sampler, wl1, est1 = (main_out.pop(k) for k in ("sampler", "wl",
                                                         "est"))
    prof = phase_profile(main_sampler, args.round_batch,
                         args.round_batch / main_out["engine_samples_per_s"])
    for r in rows:
        r["launches"] = main_out["launches"][r["name"]]
        r["path"] = "UQ1 main path"
        r["launches_by_path"] = {"UQ1 static": r["launches"]}
    print("[main] " + json.dumps(main_out), flush=True)
    print("[profile] " + json.dumps(prof), flush=True)
    mark("main")

    def path_launches(label, out):
        for r in rows:
            if r["name"] in ("sorted_probe", "probe_pick"):
                r["launches_by_path"][label] = out["launches"][r["name"]]

    # 5. the adaptive round planner on the same UQ1 state, served the same
    from repro_torch.core.union_sampler import SetUnionSampler
    t0 = time.perf_counter()
    ad_sampler = SetUnionSampler(wl1.cat, wl1.joins, est1.cover, seed=0,
                                 device="cuda", round_batch=args.round_batch,
                                 plan="adaptive")
    ad_out = run_path("adaptive", "UQ1", args.scale, args.requests,
                      args.samples, args.round_batch,
                      ("sorted_probe", "probe_pick"),
                      built=(ad_sampler, wl1, est1,
                             time.perf_counter() - t0))
    for k in ("sampler", "wl", "est"):
        ad_out.pop(k)
    ad_prof = phase_profile(ad_sampler, args.round_batch,
                            args.round_batch / ad_out["engine_samples_per_s"])
    ad_out["slot_width"] = ad_sampler.engine._slot_width
    ad_out["static"] = {k: main_out[k] for k in (
        "piece_batches", "engine_samples_per_s", "samples_per_s", "psi",
        "rounds_per_sample_call", "host_syncs_per_sample_call")}
    ad_out["static"]["device_ms_per_call"] = prof["device_ms_per_call"]
    ad_out["static"]["slot_width"] = args.round_batch
    ad_out["profile"] = ad_prof

    def engine_rate(sampler, calls=4):
        t0 = time.perf_counter()
        for _ in range(calls):
            sampler.sample(args.round_batch)
        torch.cuda.synchronize()
        return calls * args.round_batch / (time.perf_counter() - t0)
    # both plans in turns on the same state (static, adaptive, adaptive,
    # static): the host-bound rate drifts between phases of one run
    ad_out["paired_engine_samples_per_s"] = [
        [plan, engine_rate(smp)] for plan, smp in (
            ("static", main_sampler), ("adaptive", ad_sampler),
            ("adaptive", ad_sampler), ("static", main_sampler))]
    del ad_sampler
    path_launches("UQ1 adaptive", ad_out)
    print("[adaptive] " + json.dumps(ad_out), flush=True)
    mark("adaptive")

    # the device loop against the host loop on the same UQ1 state, then
    # /metrics read from a live service on it
    dl_out = phase_device_loop(wl1, est1, args.round_batch,
                               main_sampler.backend)
    path_launches("UQ1 device loop", dl_out)
    print("[device-loop] " + json.dumps(dl_out), flush=True)
    mark("device-loop")
    met_out = phase_metrics(wl1, est1, args.round_batch, main_sampler.backend)
    print("[metrics] " + json.dumps(met_out), flush=True)
    mark("metrics")

    # 6. the kernel entry point; segdegree and decode attention are reached
    # only through it (the UQ1 path launches neither)
    sweeps = phase_ops_sweeps()
    print(f"[ops] edge sweeps, kernel vs plain: {json.dumps(sweeps)}",
          flush=True)
    ops_rows, ops_out = phase_ops(main_sampler, seed=0)
    del main_sampler
    for r in ops_rows:
        r["main_path_launches"] = main_out["launches"][r["name"]]
    rows.extend(ops_rows)
    print("[ops] " + json.dumps(ops_out), flush=True)
    mark("ops")

    # 7. residual path
    # UQ4 has no weighted node: its tree and residual hops all run probe_pick
    pick_row = next(r for r in rows if r["name"] == "probe_pick")
    res_out = run_path("residual", "UQ4", args.uq4_scale, 4, args.samples,
                       args.round_batch, ("probe_pick",),
                       before_serve=lambda s: pick_row.update(
                           phase_residual_probe(s)))
    res_sampler, wl4, est4 = (res_out.pop(k) for k in ("sampler", "wl",
                                                       "est"))
    path_launches("UQ4 residual", res_out)
    print("[residual] " + json.dumps(res_out), flush=True)
    dl4, dev4, _ = _mode_parity("device-loop", wl4, est4, args.round_batch,
                                (8192, 3333), res_sampler.backend)
    # UQ4's tree and residual hops all run probe_pick (no sorted_probe)
    dl4["replay"] = _replay_events("device-loop", dev4, args.round_batch,
                                   ("probe_pick",))
    print("[device-loop] UQ4 " + json.dumps(dl4), flush=True)
    del res_sampler, wl4, est4, dev4
    mark("residual")

    # 8. a branching tree
    uq3_out = phase_branching_tree(args.scale, args.round_batch)
    print("[uq3] draws through the kernels == plain versions (exact): "
          + json.dumps(uq3_out), flush=True)
    mark("uq3")

    # 9. wander join on the UQ1 state: the walks' hops, the random-walk
    # warm-up and ONLINE-UNION (Algorithm 2), all through probe_pick
    probe_row = next(r for r in rows if r["name"] == "sorted_probe")
    walks_out = phase_walks(wl1)
    pick_row.update({k: v for k, v in walks_out.items()
                     if k.startswith("walk_")})
    print("[walks] " + json.dumps(walks_out), flush=True)
    mark("walks")
    rw_out = phase_rw_warmup(wl1, est1.cover, args.rw_max_walks)
    pick_row["launches_by_path"]["UQ1 rw-warmup"] = \
        rw_out["launches"]["probe_pick"]
    print("[rw-warmup] " + json.dumps(rw_out), flush=True)
    mark("rw-warmup")
    online_out = phase_online(wl1, (args.online_samples,
                                    2 * args.online_samples))
    pick_row["launches_by_path"]["UQ1 online walks"] = \
        online_out["walk_launches"]["probe_pick"]
    pick_row["launches_by_path"]["UQ1 online draws"] = \
        online_out["draw_launches"]["probe_pick"]
    probe_row["launches_by_path"]["UQ1 online draws"] = \
        online_out["draw_launches"]["sorted_probe"]
    print("[online] " + json.dumps(online_out), flush=True)
    mark("online")

    # 10. on the UQ1 state: the paper's baselines, the chain façade, the
    # seed-split and hash-partition replicas and the sharded engine at
    # world 1, all on one TorchBackend (built once, not counted in them)
    from repro_torch.core.backends.torch_backend import TorchBackend
    t0 = time.perf_counter()
    backend1 = TorchBackend(wl1.cat, wl1.joins, device="cuda", seed=0)
    torch.cuda.synchronize()
    backend1_s = time.perf_counter() - t0
    base_out = phase_baselines(wl1, rw_out["union_size_cover"], backend1)
    base_out["backend_build_s"] = backend1_s
    path_launches("UQ1 disjoint", base_out["disjoint"])
    path_launches("UQ1 bernoulli", base_out["bernoulli"])
    print("[baselines] " + json.dumps(base_out), flush=True)
    mark("baselines")
    chain_out = phase_chain(wl1)
    path_launches("UQ1_J0 chain", chain_out)
    print("[chain] " + json.dumps(chain_out), flush=True)
    mark("chain")
    rep_out = phase_replicas(wl1, est1, args.round_batch, backend1)
    path_launches("UQ1 replicas", rep_out)
    print("[replicas] " + json.dumps(rep_out), flush=True)
    mark("replicas")
    sh_out = phase_sharded(wl1, est1, args.round_batch, backend1)
    path_launches("UQ1 sharded static", sh_out["static"])
    path_launches("UQ1 sharded adaptive", sh_out["adaptive"])
    print("[sharded] " + json.dumps(sh_out), flush=True)
    mark("sharded")
    del backend1
    she_out = phase_sharded_est(wl1, rw_out, args.rw_max_walks)
    pick_row["launches_by_path"]["UQ1 sharded rw-warmup"] = \
        she_out["launches"]["probe_pick"]
    print("[sharded-est] " + json.dumps(she_out), flush=True)
    mark("sharded-est")
    del wl1, est1

    # ... the serve CLI with --shards 1, and two gloo ranks on the card
    from repro_torch.kernels import probe
    from repro_torch.launch.serve import main as serve_main
    probe.reset_launch_counts()
    scli_out = serve_main(["--mode", "samples", "--workload", "UQ1",
                           "--scale", str(SHARDS_SCALE), "--requests", "4",
                           "--device", "cuda", "--shards", "1"])
    scli_out["launches"] = _launches()
    _require_probes("shards-cli", scli_out["launches"])
    path_launches("UQ1 CLI --shards 1", scli_out)
    print("[shards-cli] " + json.dumps(scli_out), flush=True)
    mark("shards-cli")
    w2_out = phase_sharded_w2(SHARDS_SCALE, args.round_batch)
    path_launches("UQ1 sharded world 2 (rank 0)", w2_out["ranks"][0])
    print("[sharded-w2] " + json.dumps(w2_out), flush=True)
    mark("sharded-w2")

    # 8. §8.3 predicates: UQ2 pushdown (masked base indexes shared by the
    # three flavours; every node weighted, so sorted_probe only) ...
    uq2_pre: dict = {}

    def uq2_checks(sampler):
        uq2_pre["draws_kernel_eq_plain"] = phase_draw_parity(
            sampler, max(sampler.engine.piece_batches))
        if sampler.joins[0].pushdown_base is not None:
            uq2_pre["shared_indexes"] = phase_shared_indexes(sampler)

    def uq2_exact(pred_mode, est=None):
        """UQ2 over the exact warm-up's cover.  The three flavours' histogram
        bounds are equal, and at this scale that cover gives JP and JS no
        mass (the reference's does the same); the exact cover gives JN and
        JP theirs (JS lies inside JN ∪ JP).  Rejection mode takes pushdown's
        ``est``: the same union over the same data, so the same exact piece
        sizes, without a second exact warm-up over the unfiltered joins."""
        from repro_torch.core.framework import estimate_union, warmup
        from repro_torch.data.workloads import uq2
        t0 = time.perf_counter()
        wl = uq2(scale=args.scale, seed=0, pred_mode=pred_mode)
        uq2_pre["warmup"] = "exact" if est is None else "exact, pushdown's"
        if est is None:
            est = estimate_union(warmup(wl.cat, wl.joins,
                                        method="exact").oracle)
        smp = SetUnionSampler(wl.cat, wl.joins, est.cover, seed=0,
                              device="cuda", round_batch=args.round_batch)
        uq2_pre["piece_sizes"] = [est.cover.piece_sizes[n]
                                  for n in est.cover.order]
        return smp, wl, est, time.perf_counter() - t0

    uq2_out = run_path("uq2", "UQ2", args.scale, 8, args.samples,
                       args.round_batch, ("sorted_probe",),
                       before_serve=uq2_checks, built=uq2_exact("pushdown"))
    uq2_out.update(uq2_pre)
    uq2_static, wl2, est2 = (uq2_out.pop(k) for k in ("sampler", "wl",
                                                       "est"))
    path_launches("UQ2 pushdown", uq2_out)
    print("[uq2] " + json.dumps(uq2_out), flush=True)
    mark("uq2")

    # ... the same state under plan="adaptive", served and checked like
    # [uq2], then engine calls in turns with the static plan ...
    t0 = time.perf_counter()
    uq2_ad = SetUnionSampler(wl2.cat, wl2.joins, est2.cover, seed=0,
                             device="cuda", round_batch=args.round_batch,
                             plan="adaptive")
    uq2_ad_out = run_path("uq2-adaptive", "UQ2", args.scale, 8, args.samples,
                          args.round_batch, ("sorted_probe",),
                          built=(uq2_ad, wl2, est2,
                                 time.perf_counter() - t0))
    for k in ("sampler", "wl", "est"):
        uq2_ad_out.pop(k)
    uq2_ad_out["slot_width"] = uq2_ad.engine._slot_width
    uq2_ad_out["paired_engine_samples_per_s"] = [
        [plan, engine_rate(smp)] for plan, smp in (
            ("static", uq2_static), ("adaptive", uq2_ad),
            ("adaptive", uq2_ad), ("static", uq2_static))]
    del uq2_ad, uq2_static
    path_launches("UQ2 adaptive", uq2_ad_out)
    print("[uq2-adaptive] " + json.dumps(uq2_ad_out), flush=True)
    mark("uq2-adaptive")

    # ... the serve CLI as a user runs it (histogram warm-up, adaptive; its
    # cover serves JN only, see uq2_exact) ...
    probe.reset_launch_counts()
    cli_out = serve_main(["--mode", "samples", "--workload", "UQ2",
                          "--plan", "adaptive", "--scale", str(args.scale),
                          "--requests", "8", "--device", "cuda"])
    torch.cuda.synchronize()
    cli_out["launches"] = dict(probe.launch_counts)
    if cli_out["launches"]["sorted_probe"] <= 0:
        raise AssertionError("[uq2-cli] the CLI launched no sorted_probe")
    path_launches("UQ2 CLI adaptive", cli_out)
    print("[uq2-cli] " + json.dumps(cli_out), flush=True)
    mark("uq2-cli")

    # ... UQ2 rejection (nation and supplier weighted, partsupp and part
    # uniform: both probes; in-round predicate masks) ...
    uq2_pre.clear()
    rej_out = run_path("uq2-rejection", "UQ2", args.scale, 8, args.samples,
                       args.round_batch, ("sorted_probe", "probe_pick"),
                       before_serve=uq2_checks,
                       built=uq2_exact("rejection", est2))
    rej_out.update(uq2_pre)
    rej_sampler, wl2r, _ = (rej_out.pop(k) for k in ("sampler", "wl", "est"))
    if rej_out["pred_rejects"] <= 0:
        raise AssertionError("[uq2-rejection] no predicate rejections")
    path_launches("UQ2 rejection", rej_out)
    print("[uq2-rejection] " + json.dumps(rej_out), flush=True)
    dl2, dev2, _ = _mode_parity("device-loop", wl2r, est2, args.round_batch,
                                (8192, 3333), rej_sampler.backend)
    if dev2.stats.pred_rejects <= 0:
        raise AssertionError("[device-loop] UQ2 rejection: no predicate "
                             "rejections")
    dl2["replay"] = _replay_events("device-loop", dev2, args.round_batch,
                                   ("sorted_probe", "probe_pick"))
    print("[device-loop] UQ2 rejection " + json.dumps(dl2), flush=True)
    del rej_sampler, wl2r, dev2
    mark("uq2-rejection")

    # ... and record-mode membership over UQ2 pushdown
    rec_out = phase_record(wl2, est2, args.round_batch, 4096)
    del wl2, est2
    path_launches("UQ2 record", rec_out)
    print("[record] " + json.dumps(rec_out), flush=True)
    mark("record")

    # 11. small-input reference on the card
    ps = {"UQ1 static": phase_small_reference(),
          "UQ1 adaptive": phase_small_reference(plan="adaptive"),
          "UQ2 pushdown": phase_small_reference("UQ2"),
          "UQ2 rejection": phase_small_reference("UQ2",
                                                 pred_mode="rejection"),
          "UQ2 record": phase_small_reference("UQ2", membership="record")}
    print("[reference] UQ1 and UQ2 at scale 0.05 uniform over the exact "
          "union on the card: chi-square p " + json.dumps(ps), flush=True)
    mark("reference")
    online_ref = phase_online_reference()
    print("[reference] ONLINE UQ1 at scale 0.05 on the card, the "
          "reference's Algorithm-2 bar: " + json.dumps(online_ref), flush=True)
    mark("reference online")

    cuts = [f"{what} {got:g} (full: {full:g})" for what, got, full in (
        ("UQ1 scale", args.scale, UQ1_SCALE),
        ("UQ4 scale", args.uq4_scale, UQ4_SCALE),
        ("[online] sample(n)", args.online_samples, ONLINE_SAMPLES),
        ("[rw-warmup] rw_max_walks", args.rw_max_walks, RW_MAX_WALKS))
        if got != full]
    if cuts:
        print("[cut] " + ", ".join(cuts), flush=True)
    print("[phases] wall seconds: " + json.dumps(
        {b[0]: round(b[1] - a[1], 2) for a, b in zip(marks, marks[1:])}
        | {"total": round(marks[-1][1] - marks[0][1], 2)})
        + f"; 'reference online' is a standing cost: "
        f"{online_ref['dropped_slots']} of its {online_ref['iterations']} "
        "iterations are dropped slots (an empty join that keeps its "
        "histogram size in Algorithm 2)", flush=True)
    print(f"[profiler] sessions with no device activity, run again: "
          f"{EMPTY_TRACES[0]}", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
