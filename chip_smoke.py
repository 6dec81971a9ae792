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
   selection law; ``member_lookup`` (B5) must launch on it, as on
   ``[adaptive]``, ``[device-loop]`` and ``[replicas]``;
4b. member lookup (``[member-lookup]``) — ``member_lookup`` at the last
   probing join of UQ1 (this state) and of Q5 (the benchmark's
   ``q5-sf1`` program, TPC-H SF 1, built as the benchmark builds it), on
   the inputs of a real round (a host-loop engine's first round at the
   round batch, the call recorded): verdicts and lookup count bit-equal to
   ``member_lookup_plain``, device ms of the call and of the kernel, the
   plain version's ms, launches per call, the byte bound and the chain of
   dependent loads (``levels``), the ptxas report; Q5's device loop must
   launch it, once per probing join of a replayed round;
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
   widths launch; then decode attention at every (H, KVH, D) of the
   configs and their smoke configs (``cases.config_attention_shapes``: D
   16, 64, 112, 128 and 256, G from 1 to 48), bf16, B 8, S 4096, each
   within rtol 1e-2, atol 1e-3 of the plain version and timed beside its
   bound, the plain version and ``scaled_dot_product_attention``, one
   ``kernels`` row each; shapes the kernel does not take must raise;
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
   on its ``ShardedCatalog``, in their default per-rank device loop (one
   CUDA graph per capacity class), three ``sample(8192)`` each, bit-equal
   to the sharded host loop and to the unsharded device loop with the same
   seed (rows, homes, fingerprints, ``SamplerStats``), and the three
   engines' rates in turns; ``[host-engine]``: the host engine and three
   of the reference's degrade paths, each held to exactly the
   ``record_fallback`` events it expects — the mixed union (UQ1 with its
   last cover piece's join given one dangling row at ``1 << 31``: that join
   draws on the host, membership goes to the host oracle, the other joins
   draw through B1/B2; two ``sample(4096)``), ``strict_paper_loop`` over
   the card's sources (``sample(256)``), and EO refused by the device
   backend then drawn by the host engine (``sample(1024)``);
   ``[sharded-est]``: ``warmup(method="random_walk", mesh=world 1)`` equal
   to ``[rw-warmup]`` (sizes, half-widths, walks, the cover's union);
   ``[shards-cli]``: the serve CLI with ``--shards 1`` (UQ1 at
   ``SHARDS_SCALE``, 4 requests); ``[sharded-w2]``: two processes on the
   one card in a gloo group (NCCL refuses two ranks on one device), UQ1 at
   ``SHARDS_SCALE`` with ``shards=2``, 4 × 4096 on each rank in the
   per-rank device loop (eager chunks: collectives are not captured) and
   then in the host loop: the same stream on both ranks in each loop (a
   SHA-256 of the rows), rows in their home piece, chunks and host syncs
   per call, and both loops' per-rank rates in turns;
11. small-input reference — UQ1 (static and adaptive) and UQ2 (pushdown,
   rejection and record mode) at scale 0.05 are sampled uniformly over
   their exact unions (chi-square), on the card, and every row is in its
   home piece and in no earlier one (record mode included); ONLINE UQ1 at
   scale 0.05 meets the reference's Algorithm-2 bar (``sample(40·U)``:
   ≥ 0.9·U distinct rows, max count ≤ 12× the mean, reuse accepts > 0);
12. LM serving (``[lm]``) — gemma2-9b and then minitron-8b at full width
   from random weights (``init_params``, seeded, bf16 weights, one model on
   the card at a time): ``serve_lm`` at the serve CLI's defaults (4 slots,
   8 requests, 16 new tokens, ``max_len`` 64; requests, steps, steps/s,
   tokens/s) with B4 launched exactly twice per attention layer and decode
   step (counts set to 0 just before, read just after); device ms per
   step (profiler); nine decode steps through B4 against the same steps
   with ``attention.decode_attention`` replaced by the plain version by
   the phase (``cases.lm_logits_agreement``: correlation > 0.999, largest
   difference ≤ 10 % of the largest logit, greedy agreement ≥ 0.5) and
   the last step against ``prefill_step`` (the reference's bar:
   correlation > 0.99, top-1 ≥ 0.5); for gemma2-9b one step at 8 slots,
   lengths in [4096, 8192), ``max_len`` 8192, caches filled from a seeded
   generator: device ms, B4's share, the device busy share, the byte
   bound (weights + kept K/V rows), peak memory; then
   ``python -m repro_torch.launch.serve --mode lm --smoke --arch
   gemma2-9b`` in a subprocess (D 16 in B4), which must exit 0;
12b. the other families (``[lm-families]``) — mamba2-780m, zamba2-7b,
   whisper-medium, paligemma-3b and phi3.5-moe (16 of its 32 layers,
   printed under ``reduced``) at full width from random bf16 weights, one
   model on the card at a time: ``serve_lm`` at the CLI's defaults with
   exactly 0 / 13 / 48 / 18 / 16 B4 calls (two launches each) per decode
   step; device ms, busy share, byte bound and peak memory of a step at
   the CLI's shape; for zamba2-7b and whisper-medium one step at 8 slots ×
   8k context (every cache, whisper's cross K/V too, from a seeded
   generator: device ms, B4's share, busy share, byte bound); nine steps
   through B4 against the plain version and, for mamba2, zamba2 and
   phi3.5-moe, the last step against ``prefill_step`` — on the bf16 model,
   or in float32 where bf16 rounding swamps the check (``FAMILY_F32``;
   phi3.5-moe's prefill dropless where its capacity factor drops tokens
   that decode keeps); then ``python -m repro_torch.launch.serve --mode lm
   --smoke --arch zamba2-7b`` in a subprocess, which must exit 0;
13. training (``[train]``) — one float32 train step of a smoke config of
   each of the seven families (unionlm, gemma2, phi3.5-moe, mamba2,
   zamba2, whisper and paligemma, with frontend embeddings for the last
   two) from numpy parameters on the card and on the CPU, held to the CPU
   tests' limits; then ``repro_torch.launch.train.main``
   at unionlm-100m's full width on UQ3 at scale 100 (B 16, S 1024, 30
   steps, a checkpoint every 10) with the launch counts set to 0 just
   before and read just after (``probe_pick`` > 0; UQ3 runs no
   ``sorted_probe``): steady-state tokens/s, the sampler's share, peak
   memory, the first and last loss (the last must be lower); the same
   ``build_pipeline`` on UQ1 at scale 1 for two batches (both probes > 0:
   UQ1's weighted nodes run ``sorted_probe``); two more
   steps under the profiler (device ms, busy share, kernels per step); and
   a ``TrainSupervisor`` on the same pipeline with one failure injected
   after its first checkpoint: one restart, the target step, and the state
   restored from ``LATEST`` bit-equal to the state saved;
14. the other families' training (``[train-families]``) — mamba2-780m
   (through ``launch.train.main``, B 8 × S 1024), zamba2-7b (45 of 81
   layers), whisper-medium (B 8 × S 448 + 1,500 frames), paligemma-3b (B 4
   × S 512 + 256 patches) and phi3.5-moe (2 of 32 layers) at their
   published widths from random init, 10 steps each on UQ3 samples at
   scale 100, one model at a time: steady tokens/s, device ms, busy share
   and kernels per step over two profiled steps, peak memory, the first
   and last loss (the last must be lower), ``probe_pick`` > 0 on each
   model's pipeline (counts set to 0 just before its steps);
15. model sharding (``[model-sharding]``) — ``moe_ffn_dist`` at
   phi3.5-moe's MoE widths (d 4096, 16 experts, d_ff 6400, top-2; B 4 × S
   256, float32) on a world-1 mesh and on two gloo ranks on the card
   (model 2), each against ``moe_ffn`` with the same capacity (outputs,
   aux and every rank's gradients of the four weights and x, within
   ``MS_TOL`` of the largest value), and ``compressed_psum``
   on the two ranks within the reference's bar;
16. the dry-run and the audits — ``[dryrun]``:
   ``repro_torch.launch.dryrun.lower_cell`` at full width for gemma2-9b
   ``decode_32k``, mamba2-780m ``decode_32k`` and unionlm-100m
   ``train_4k`` on a fake (16, 16) process group (each step traced on meta
   tensors at one and two blocks and its census scaled to the full depth):
   the roofline terms of each, B4 counted by name in gemma2-9b's census
   exactly ``attention_calls_per_step`` times, and no change to
   ``torch.cuda.memory_allocated`` or to the launch counts across the
   traces; ``[audits]``: the capture audit on the card for UQ1 (scale
   0.02) under both plans (one static buffer set and one CUDA-graph
   capture per capacity class; B1 and B2 launch in the captured rounds)
   and the lint gate ``python -m repro_torch.analysis --layers ast``, with
   no finding.

Every served path runs the engine's default round loop,
``fused_rounds="device"``: one round captured as a CUDA graph per capacity
class and replayed in chunks, one host sync per chunk; a replay adds the
kernels recorded in one round to the launch counts.  No phase but
``[host-engine]`` may record an engine fallback
(``repro_torch.obs.fallback_events``): the run fails if one does.

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
more device-mode call runs under the profiler: its probe and
``member_lookup`` kernel events (inside graph replays) must equal exactly
the launches recorded in one captured round × the rounds replayed, which
is what the launch counts add.
``[metrics]`` serves UQ1 with a ``MetricsServer`` on an ephemeral port and
scrapes ``/healthz`` and ``/metrics`` over localhost: the engine and serve
series, under the reference's names, equal the engine's counters.  The
``kernels`` rows of ``sorted_probe`` and ``probe_pick`` give their launches
on each served path (``launches_by_path``; the online sampler's walks and
draws, the random-walk warm-up, the baselines, the chain façade, the
replicas, the sharded engine in both loops and its warm-up, the
``[host-engine]`` mixed union and ``strict_paper_loop``, the ``--shards 1``
CLI and rank 0 of ``[sharded-w2]`` in both loops among them), and the
``probe_pick`` row
its time at walk width (``walk_ms`` and the ``walk_`` keys).  The
``decode_attention`` row's ``launches`` are ``[lm]``'s gemma2-9b
``serve_lm`` run, with the ``[ops]``, minitron-8b and ``[lm-families]``
counts under ``launches_by_path`` and ``launches_per_decode_step`` beside
them; the
``sorted_probe`` and ``probe_pick`` rows carry ``[train]``'s counts under
``launches_by_path`` too, and ``probe_pick``'s ``[train-families]``.

The ``member_lookup`` row's ``launches`` are ``[main]``'s, with the other
served UQ1 paths under ``launches_by_path`` and Q5's numbers under
``q5_`` keys.

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


def _member_round_inputs(sampler, round_batch: int):
    """The inputs of the last probing join's ``member_lookup`` in one real
    round: a host-loop engine on ``sampler``'s backend, cover and plan runs
    one ``sample(round_batch)`` with ``member.member_lookup`` wrapped, and
    the first launch over the most earlier pieces is kept (its plan, the
    candidates' columns, the live mask after the draw, residual test,
    budget and predicates, and the earlier pieces' predicate masks)."""
    from repro_torch.core.union_sampler import SetUnionSampler
    from repro_torch.kernels import member
    real, kept = member.member_lookup, []

    def record(plan, rows, acc=None, preds=None):
        if not kept or len(plan.pieces) > len(kept[0].pieces):
            kept[:] = [plan, {a: c.clone() for a, c in rows.items()},
                       acc.clone(), [None if m is None else m.clone()
                                     for m in preds]]
        return real(plan, rows, acc, preds)

    host = SetUnionSampler(sampler.cat, sampler.joins, sampler.cover, seed=7,
                           backend=sampler.backend, device="cuda",
                           round_batch=round_batch, plan=sampler.plan,
                           fused_rounds="host")
    member.member_lookup = record
    try:
        host.sample(round_batch)
    finally:
        member.member_lookup = real
    return kept


def phase_member_lookup(sampler, round_batch: int) -> dict:
    """``member_lookup`` (B5) at the last probing join of ``sampler``'s
    union, on the inputs of a real round (:func:`_member_round_inputs`):
    verdicts and lookup count bit-equal to ``member_lookup_plain``; device
    ms of the call (the counter's memset with it) and of the kernel alone,
    the plain version's ms, the launches per call, and the bound: bytes
    (the live mask read and the verdicts written, 1 B a candidate; per live
    candidate and earlier piece, every relation's columns, 4 B each, and
    the salt-1 and salt-2 entries of its hit, 16 B) over HBM bandwidth.
    The kernel is bound instead by its longest chain of dependent loads,
    ``levels``: the lower bound over the largest index, then its
    ``kmax`` window."""
    from repro_torch.kernels import build, member
    plan, rows, acc, preds = _member_round_inputs(sampler, round_batch)
    kern = lambda: member.member_lookup(plan, rows, acc, preds)  # noqa: E731
    plain = lambda: member.member_lookup_plain(  # noqa: E731
        plan, rows, acc, preds)
    a, b = kern(), plain()
    _check_equal(a, b, "member_lookup at the last probing join")
    live = int(acc.sum())
    piece_bytes = [sum(4 * len(r[0]) + 16 for r in piece)
                   for piece in plan.pieces]
    nbytes = 2 * acc.numel() + live * sum(piece_bytes)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    kernel_ms, events = _kernel_event_ms(kern, "member_lookup_kernel")
    out = {
        "ms": _device_ms(kern), "kernel_ms": kernel_ms,
        "kernel_events_per_call": events, "plain_ms": _device_ms(plain),
        "call_ms": _call_ms(kern), "plain_call_ms": _call_ms(plain),
        "bound_ms": bound_ms, "bound_by": "bytes", "bound_bytes": nbytes,
        "bound_share": bound_ms / kernel_ms,
        "levels": max(math.ceil(math.log2(r[4])) + r[3] + 1
                      for piece in plan.pieces for r in piece if r[4]),
        "launches_per_call": _launches_per_call("member_lookup", kern),
        "candidates": acc.numel(), "live": live,
        "lookups": int(a[1]), "pieces": len(plan.pieces),
        "relations": [len(piece) for piece in plan.pieces],
        "columns": len({x for piece in plan.pieces for r in piece
                        for x in r[0]}),
        "index_rows": max(r[4] for piece in plan.pieces for r in piece),
        "ptxas": _ptxas_stats(build.build()["log"], "member_lookup_kernel",
                              "member_lookup_kernel"),
    }
    if int(a[1]) != live * len(plan.pieces):
        raise AssertionError(f"member_lookup: {int(a[1])} lookups for {live} "
                             f"live candidates and {len(plan.pieces)} pieces")
    return out


def phase_member_q5(round_batch: int, seed: int = 7330000001) -> dict:
    """Q5's cell program (``unionbench/configs/q5-sf1.json``: TPC-H SF 1,
    three cyclic joins, exact cover, adaptive plan) built as the benchmark
    builds it: ``member_lookup`` at its last probing join
    (:func:`phase_member_lookup`), and the launches of one 8,192-row call of
    its device loop (counts set to 0 just before, read just after; > 0)
    beside the launches recorded in one captured round."""
    import torch
    from repro_torch.kernels import build
    from unionbench import harness, inputs, program
    config = harness.load_json(os.path.join(HERE, "unionbench", "configs",
                                            "q5-sf1.json"))
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    cat, joins = program.specs(inputs.build(config, seed))
    cov = program.cover(config, cat, joins, seed, dev)
    smp = program.set_union_sampler(config, cat, joins, cov, seed, dev)
    torch.cuda.synchronize()
    out = {"build_s": time.perf_counter() - t0, "seed": seed,
           "piece_batches": list(smp.engine.piece_batches)}
    out.update(phase_member_lookup(smp, round_batch))
    smp.sample(round_batch)                 # its capacity class captured
    build.reset_launch_counts()
    smp.sample(round_batch)
    out["device_loop_launches"] = _launches()["member_lookup"]
    if out["device_loop_launches"] <= 0:
        raise AssertionError("[member-lookup] Q5's device loop launched no "
                             "member_lookup")
    C = 1 << max(10, (round_batch - 1).bit_length())
    out["launches_per_round"] = \
        smp.engine._buffers[C].replay_launches["member_lookup"]
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
    # the entry point's kernels; member_lookup is the round's alone
    # ([member-lookup] checks it)
    missing = [name for name in ("sorted_probe", "probe_pick", "segdegree",
                                 "decode_attention") if launches[name] <= 0]
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


# [ops]: decode attention at every attention shape of the configs, at B
# requests of a context of S slots
CONFIG_ATTN_BATCH, CONFIG_ATTN_SEQ = 8, 4096


def phase_attention_shapes(seed: int) -> list:
    """Decode attention at every (H, KVH, D) of the configs and their smoke
    configs (``cases.config_attention_shapes``), bf16, B 8, S 4096, lengths
    drawn in [S/2, S] as ``cases.attention_inputs`` draws them, softcap 0:
    each call against the plain version in fp32 (``attention_tol``), and
    timed beside its bound, the plain version and
    ``scaled_dot_product_attention`` (``enable_gqa``) on the same inputs.
    The counts are set to 0 just before the calls and read after each.
    Returns one ``kernels`` row per shape."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import attention, build
    from repro_torch.kernels.cases import attention_tol, config_attention_shapes
    B, S = CONFIG_ATTN_BATCH, CONFIG_ATTN_SEQ
    tol = attention_tol(torch.bfloat16)
    rows = []
    build.reset_launch_counts()
    for i, (H, KVH, D) in enumerate(config_attention_shapes()):
        g = torch.Generator(device="cuda")
        g.manual_seed(seed + i)
        q, k, v = (torch.randn(sh, generator=g, device="cuda").to(
            torch.bfloat16) for sh in ((B, H, D), (B, S, KVH, D),
                                       (B, S, KVH, D)))
        lens = torch.randint(S // 2, S + 1, (B,), generator=g, device="cuda")
        before = build.launch_counts["decode_attention"]
        out = attention.decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        launched = build.launch_counts["decode_attention"] - before
        want = attention.decode_attention_plain(q.float(), k.float(),
                                                v.float(), lens)
        torch.testing.assert_close(out.float(), want, **tol)
        err = float((out.float() - want).abs().max())
        del want
        kt, vt = (x.transpose(1, 2).contiguous() for x in (k, v))
        mask = (torch.arange(S, device="cuda")[None, :]
                < lens[:, None])[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(
                q.unsqueeze(2), kt, vt, attn_mask=mask, enable_gqa=True)
        b_ms, b_by = _attention_bound(q, k, lens, 0)
        row = {
            "name": f"decode_attention H{H}/KVH{KVH}/D{D}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/attention.cu",
            "replaces": "src/repro/kernels/attention.py:32",
            "launches": launched, "path": "ops (config shapes)",
            "max_abs_err": err,
            "ms": _device_ms(lambda: attention.decode_attention(q, k, v, lens),
                             reps=20),
            "plain_ms": _device_ms(lambda: attention.decode_attention_plain(
                q, k, v, lens), reps=3, warm=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": _device_ms(library, reps=20),
            "library_note": "scaled_dot_product_attention(attn_mask, "
                            "enable_gqa=True), K/V as (B, KVH, S, D)",
            "shape": {"B": B, "S": S, "H": H, "KVH": KVH, "D": D, "G": H // KVH,
                      "dtype": "bfloat16", "softcap": 0.0, "window": 0},
            "tolerance": tol,
            "ctas": attention.kernel_ctas(H, KVH, D, True, q.device),
        }
        row["bound_share"] = b_ms / row["ms"]
        row["vs_library"] = row["ms"] / row["library_ms"]
        rows.append(row)
        del q, k, v, kt, vt, out
    # a shape the kernel does not take raises and launches nothing
    before = dict(build.launch_counts)
    for H, KVH, D in ((4, 2, 32), (49, 1, 64)):
        z = torch.zeros((1, 8, KVH, D), device="cuda")
        try:
            attention.decode_attention(torch.zeros((1, H, D), device="cuda"),
                                       z, z, torch.tensor([8], device="cuda"))
        except ValueError:
            continue
        raise AssertionError(f"[ops] decode attention took H {H}, KVH {KVH}, "
                             f"D {D}")
    if dict(build.launch_counts) != before:
        raise AssertionError("[ops] a refused attention shape launched")
    return rows


# [lm]: the serve CLI's defaults (src/repro/launch/serve.py:104-111), the
# decode steps held against the plain path and against prefill, and
# gemma2-9b's real-context step
LM_ARCHS = ("gemma2-9b", "minitron-8b")
LM_CLI = {"slots": 4, "requests": 8, "max_new": 16, "max_len": 64}
LM_CHECK_STEPS = 9
LM_CONTEXT = {"slots": 8, "max_len": 8192, "lo": 4096, "hi": 8192}


def _lm_steps(cfg, params, toks, max_len: int):
    """Decode ``toks`` (B, T) one step at a time from an empty cache at
    lengths 0..T-1; returns the (T, B, vocab) logits and the B4 launches of
    each step."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.models.serve import decode_step, init_cache
    B, T = toks.shape
    cache = init_cache(cfg, B, max_len, device="cuda")
    logits, launches = [], []
    for t in range(T):
        before = build.launch_counts["decode_attention"]
        cache, lg = decode_step(params, cfg, cache, toks[:, t:t + 1],
                                torch.full((B,), t, device="cuda"))
        torch.cuda.synchronize()
        launches.append(build.launch_counts["decode_attention"] - before)
        logits.append(lg)
    return torch.stack(logits), launches


def phase_lm(arch: str, seed: int = 0) -> dict:
    """One config at full width from random weights on the card: ``serve_lm``
    at the CLI's defaults (counts set to 0 just before, read just after: B4
    twice per attention layer and step); device ms per decode step
    (profiler); ``LM_CHECK_STEPS`` decode steps through B4 and, with
    ``attention.decode_attention`` replaced by the plain version by this
    phase, the same steps through ``decode_attention_plain``
    (``cases.lm_logits_agreement``); the last kernel step's logits against
    ``prefill_step`` over the same tokens (the reference's bar: correlation
    > 0.99, top-1 agreement >= 0.5); for gemma2-9b one timed step at a real
    context (``LM_CONTEXT``).  Frees the model before it returns."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models.serve import decode_step, init_cache
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch)
    n_attn = cfg.n_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    out = {"arch": arch, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab, "init_s": time.perf_counter() - t0,
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in params.values()),
           "n_params": sum(t.numel() for t in params.values())}

    # 1. the CLI's loop at its defaults
    build.reset_launch_counts()
    served = serve_lm(cfg, params, seed=seed, device="cuda", **LM_CLI)
    torch.cuda.synchronize()
    b4 = build.launch_counts["decode_attention"]
    if len(served["done"]) != LM_CLI["requests"]:
        raise AssertionError(f"[lm] {arch}: served {len(served['done'])} of "
                             f"{LM_CLI['requests']} requests")
    if b4 != 2 * n_attn * served["steps"]:
        raise AssertionError(f"[lm] {arch}: {b4} B4 launches in "
                             f"{served['steps']} steps, not 2 x {n_attn} each")
    out["serve_lm"] = {k: served[k] for k in ("steps", "seconds",
                                              "steps_per_s", "tokens_per_s")}
    out["serve_lm"].update(cli=LM_CLI, requests_served=len(served["done"]),
                           b4_launches=b4,
                           b4_launches_per_step=b4 / served["steps"],
                           first_tokens=[t[:4] for _, t in served["done"][:2]])

    # 2. device time of one step at the CLI's shape
    B, L = LM_CLI["slots"], LM_CLI["max_len"]
    cache = init_cache(cfg, B, L, device="cuda")
    tok1 = torch.ones((B, 1), dtype=torch.int32, device="cuda")
    lens = torch.tensor([3, 17, 30, 62][:B], device="cuda")
    out["cli_step_device_ms"] = _device_ms(
        lambda: decode_step(params, cfg, cache, tok1, lens), reps=10, warm=3)
    del cache

    # 3. kernel path against the plain path; 4. decode against prefill
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 1)
    toks = torch.randint(4, cfg.vocab, (B, LM_CHECK_STEPS), generator=g,
                         device="cuda")
    kvp = _kernel_vs_plain(cfg, params, toks, n_attn, True)
    out["decode_vs_prefill"] = _decode_vs_prefill(cfg, params, toks,
                                                  kvp.pop("last"))
    out["kernel_vs_plain"] = kvp
    out["b4_launches_per_step"] = 2 * n_attn

    # 5. gemma2-9b at a real context
    if arch == "gemma2-9b":
        out["context"] = _context_step(cfg, params, seed)
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    return out


def phase_lm_cli(arch: str = "gemma2-9b") -> dict:
    """``python -m repro_torch.launch.serve --mode lm --smoke --arch
    <arch>`` in a subprocess on the card (D 16 in B4); it must exit 0."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--mode", "lm", "--smoke", "--arch", arch],
                          cwd=HERE, env=env, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0 or not proc.stdout.startswith("served 8 requests"):
        raise AssertionError(f"[lm] the {arch} smoke CLI failed "
                             f"({proc.returncode}):\n{proc.stdout}\n"
                             f"{proc.stderr[-3000:]}")
    return {"arch": arch, "rc": proc.returncode,
            "wall_s": time.perf_counter() - t0,
            "stdout": proc.stdout.strip().splitlines()}


# [lm-families]: the other families at full width, one model on the card
# at a time: (arch, n_layers cut or None, B4 calls per decode step).  The
# calls are serve.attention_calls_per_step: one per attention layer, one per
# zamba2 group (the shared block), self + cross per whisper decoder layer,
# none for mamba2; each call launches B4's two kernels.  phi3.5-moe runs 16
# of its 32 layers: its 83.5 GB of bf16 weights do not fit one 80 GB card
FAMILY_ARCHS = (("mamba2-780m", None, 0), ("zamba2-7b", None, 13),
                ("whisper-medium", None, 48), ("paligemma-3b", None, 18),
                ("phi3.5-moe-42b-a6.6b", 16, 16))
# the reference checks decode against prefill on these (tests/test_models.py:
# 55-56); it skips the frontend archs, and so does this phase
FAMILY_PREFILL = ("mamba2-780m", "zamba2-7b", "phi3.5-moe-42b-a6.6b")
FAMILY_CONTEXT = ("zamba2-7b", "whisper-medium")
# In bf16 these random-weight models turn one-ulp differences into large
# ones (an H100 80GB HBM3 at 700 W, PERF.md §6): the SSM stacks' bf16
# prefill logits correlate 0.79 (mamba2-780m) and 0.47 (zamba2-7b) with
# the float32 prefill of the same weights, so B4's summation order alone
# moves zamba2's logits by 20 % of the largest; in phi3.5-moe a one-ulp
# change of the attention output moves a token's top-2 experts (10.7 % at
# one step; whisper-medium and paligemma-3b stay within 1.9 %).  So in
# bf16 the checks below would measure rounding, not the path: for these
# models they are held in float32, on the same weights (None) or, for
# phi3.5-moe, on a model of 8 layers from the same seed (41.8 GB in
# float32; 16 layers would need 83.5 GB), and the bf16 numbers are
# printed beside them
FAMILY_F32 = {"mamba2-780m": None, "zamba2-7b": None,
              "phi3.5-moe-42b-a6.6b": 8}


def _step_bytes(cfg, params, cache, lens) -> dict:
    """The bytes one decode step must move at ``lens``: every weight it
    reads once per use (zamba2's shared block once per group, its unused
    tail rows and whisper's encoder not at all; the embedding once, for
    the logits), each K/V row the masks keep (gemma2's local ring at most
    its window; encdec's cross rows: all ``n_frontend_tokens``), and the
    SSM state read and written."""
    import torch
    uses = {"shared.": cfg.n_zamba_groups}
    w = 0
    for k, t in params.items():
        if k.startswith("enc"):             # the encoder: prefill only
            continue
        n = t.numel() * t.element_size()
        if k.startswith("tail.") and cfg.n_zamba_tail < t.shape[0]:
            n = n * cfg.n_zamba_tail // t.shape[0]
        w += n * next((u for p, u in uses.items() if k.startswith(p)), 1)
    kv = state = 0
    for k in ("k", "k_sh", "k_loc", "k_glob", "xk"):
        if k in cache:     # (layers, B, S, KV, hd): K and V rows kept
            L, B, S = cache[k].shape[:3]
            rows = (B * S if k == "xk" else
                    int(torch.clamp(lens.long() + 1, max=S).sum()))
            kv += L * rows * 2 * cache[k][0, 0, 0].numel() * \
                cache[k].element_size()
    for k in ("h", "conv", "h_tail", "conv_tail"):
        if k in cache:
            # read, then written (h and h_tail in float32)
            el = 4 if k.startswith("h") else cache[k].element_size()
            state += 2 * cache[k].numel() * el
    total = w + kv + state
    return {"weight_bytes": w, "kv_bytes_kept": kv, "state_bytes": state,
            "bound_ms": total / HBM_BYTES_PER_S * 1e3}


def _context_step(cfg, params, seed: int) -> dict:
    """One decode step at ``LM_CONTEXT`` (8 slots, lengths in [4096, 8192),
    ``max_len`` 8192), every cache entry (whisper's ``xk``/``xv`` too, the
    SSM state in float32, as a step leaves it) from a seeded generator: its
    device ms, B4's share, the device busy share of its wall time, and its
    byte bound (``_step_bytes``)."""
    import torch
    from repro_torch.models.serve import decode_step, init_cache
    B, L = LM_CONTEXT["slots"], LM_CONTEXT["max_len"]
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 2)
    cache = init_cache(cfg, B, L, device="cuda")
    for k in ("h", "h_tail"):
        if k in cache:
            cache[k] = cache[k].float()
    for t in cache.values():
        for part in t:
            part.copy_(torch.randn(part.shape, generator=g, device="cuda"))
    lens = torch.randint(LM_CONTEXT["lo"], LM_CONTEXT["hi"], (B,),
                         generator=g, device="cuda")
    toks = torch.randint(4, cfg.vocab, (B, 1), generator=g, device="cuda")

    def step():
        return decode_step(params, cfg, cache, toks, lens)[1]
    logits = step()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[lm] {cfg.name} context step: "
                             "logits not finite")
    ev = _device_events(step, 5)
    dev_ms = sum(us for _, us in ev) / 5 / 1e3
    b4_ms = sum(us for n, us in ev if "decode_attn" in n) / 5 / 1e3
    wall_ms = _call_ms(step, reps=5, warm=1)
    out = {"slots": B, "max_len": L, "lengths": lens.tolist(),
           "device_ms": dev_ms, "b4_ms": b4_ms, "b4_share": b4_ms / dev_ms,
           "wall_ms": wall_ms, "device_busy_share": dev_ms / wall_ms,
           "cache_bytes": sum(t.numel() * t.element_size()
                              for t in cache.values()),
           "b4_events_per_step": sum(1 for n, _ in ev if "decode_attn" in n)
           / 5}
    out.update(_step_bytes(cfg, params, cache, lens))
    out["bound_share"] = out["bound_ms"] / dev_ms
    return out


def phase_lm_family(arch: str, n_layers, calls: int, seed: int = 0) -> dict:
    """One config of the other families at full width (``n_layers``: a
    depth cut, printed under ``reduced``) from random weights on the card:
    ``serve_lm`` at the CLI's defaults (counts set to 0 just before, read
    just after: exactly ``calls`` B4 calls, two launches each, per step);
    device ms per step at the CLI's shape (profiler), its busy share, byte
    bound and peak memory; for ``FAMILY_CONTEXT`` one step at a real
    context; ``LM_CHECK_STEPS`` decode steps through B4 against the same
    steps through ``decode_attention_plain`` (``cases.lm_logits_agreement``)
    and, for ``FAMILY_PREFILL``, the last step against ``prefill_step``
    (the reference's bar) — for ``FAMILY_F32`` in float32 (on the same
    weights; phi3.5-moe on 8 layers from the same seed), the bf16 numbers
    printed beside them.  Frees each model before
    the next is made."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch.serve import serve_lm
    from repro_torch.models.serve import (attention_calls_per_step,
                                          decode_step, init_cache,
                                          prefill_step)
    from repro_torch.models.transformer import init_params
    cfg = get_config(arch)
    full_layers = cfg.n_layers
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    if attention_calls_per_step(cfg) != calls:
        raise AssertionError(f"[lm-families] {arch}: "
                             f"{attention_calls_per_step(cfg)} attention "
                             f"calls per step, expected {calls}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    out = {"arch": arch, "family": cfg.family, "n_layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab,
           "init_s": time.perf_counter() - t0,
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in params.values()),
           "n_params": sum(t.numel() for t in params.values())}
    if n_layers is not None:
        out["reduced"] = (f"{n_layers} of {full_layers} layers: the full "
                          "depth's bf16 weights (83.5 GB) do not fit one "
                          "80 GB card")

    secs, clock = {}, [t0]

    def lap(label):         # wall seconds of each part, on the line
        now = time.perf_counter()
        secs[label] = now - clock[0]
        clock[0] = now
    lap("init")

    # 1. the CLI's loop at its defaults
    build.reset_launch_counts()
    served = serve_lm(cfg, params, seed=seed, device="cuda", **LM_CLI)
    torch.cuda.synchronize()
    b4 = build.launch_counts["decode_attention"]
    if len(served["done"]) != LM_CLI["requests"]:
        raise AssertionError(f"[lm-families] {arch}: served "
                             f"{len(served['done'])} of {LM_CLI['requests']}"
                             " requests")
    if b4 != 2 * calls * served["steps"]:
        raise AssertionError(f"[lm-families] {arch}: {b4} B4 launches in "
                             f"{served['steps']} steps, not 2 x {calls} each")
    out["serve_lm"] = {k: served[k] for k in ("steps", "seconds",
                                              "steps_per_s", "tokens_per_s")}
    out["serve_lm"].update(requests_served=len(served["done"]),
                           b4_launches=b4, b4_calls_per_step=calls,
                           b4_launches_per_step=b4 / served["steps"],
                           first_tokens=[t[:4] for _, t in served["done"][:2]])

    lap("serve_lm")

    # 2. device time, busy share and bound of one step at the CLI's shape
    B, L = LM_CLI["slots"], LM_CLI["max_len"]
    cache = init_cache(cfg, B, L, device="cuda")
    tok1 = torch.ones((B, 1), dtype=torch.int32, device="cuda")
    lens = torch.tensor([3, 17, 30, 62][:B], device="cuda")

    def cli_step():
        return decode_step(params, cfg, cache, tok1, lens)
    dev_ms = _device_ms(cli_step, reps=5, warm=2)
    wall_ms = _call_ms(cli_step, reps=5, warm=1)
    out["cli_step"] = {"device_ms": dev_ms, "wall_ms": wall_ms,
                       "device_busy_share": dev_ms / wall_ms}
    out["cli_step"].update(_step_bytes(cfg, params, cache, lens))
    out["cli_step"]["bound_share"] = out["cli_step"]["bound_ms"] / dev_ms
    del cache
    lap("cli_step")

    # 3. a real context
    if arch in FAMILY_CONTEXT:
        out["context"] = _context_step(cfg, params, seed)
        lap("context")

    # 4. kernel path against the plain path, decode against prefill: in
    # the config's bf16, or on the same weights in float32 (FAMILY_F32)
    g = torch.Generator(device="cuda")
    g.manual_seed(seed + 1)
    toks = torch.randint(4, cfg.vocab, (B, LM_CHECK_STEPS), generator=g,
                         device="cuda")
    held = arch not in FAMILY_F32
    out["kernel_vs_plain"] = _kernel_vs_plain(cfg, params, toks, calls,
                                              held)
    last = out["kernel_vs_plain"].pop("last")
    if held and arch in FAMILY_PREFILL:
        out["decode_vs_prefill"] = _decode_vs_prefill(cfg, params, toks, last)
    elif not held:      # printed, not held: the bf16 model's own spread
        bf16_full = prefill_step(params, cfg, {"tokens": toks})
        out["decode_vs_prefill_bf16"] = _logit_agreement(last, bf16_full)
        if cfg.family == "moe":
            out["decode_vs_prefill_bf16"]["dropless"] = _logit_agreement(
                last, prefill_step(params, _dropless(cfg), {"tokens": toks}))
    del last
    lap("checks")
    out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    del params
    torch.cuda.empty_cache()
    if not held:
        c32 = dataclasses.replace(cfg, dtype="float32",
                                  n_layers=FAMILY_F32[arch] or cfg.n_layers)
        calls = attention_calls_per_step(c32)
        params = init_params(c32, seed=seed, device="cuda")
        k32 = _kernel_vs_plain(c32, params, toks, calls, True)
        out["kernel_vs_plain_float32"] = k32
        last = k32.pop("last")
        if arch in FAMILY_PREFILL:
            out["decode_vs_prefill_float32"] = _decode_vs_prefill(
                c32, params, toks, last)
        del last
        if c32.n_layers == cfg.n_layers:
            out["bf16_vs_float32_prefill"] = _logit_agreement(
                bf16_full, prefill_step(params, c32, {"tokens": toks}))
        out["float32_n_layers"] = c32.n_layers
        out["float32_peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        del params, bf16_full
        torch.cuda.empty_cache()
        lap("float32 checks")
    out["seconds"] = secs
    out["wall_s"] = time.perf_counter() - t0
    return out


def _logit_agreement(a, b) -> dict:
    """Correlation and top-1 agreement of two (B, vocab) logit batches."""
    a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
    return {"corr": float(np.corrcoef(a.ravel(), b.ravel())[0, 1]),
            "top1": float((a.argmax(-1) == b.argmax(-1)).mean())}


def _kernel_vs_plain(cfg, params, toks, calls: int, held: bool) -> dict:
    """``LM_CHECK_STEPS`` decode steps through B4 (exactly ``2 * calls``
    launches each) and the same steps with ``attention.decode_attention``
    replaced by the plain version (none): ``cases.lm_logits_agreement``
    when ``held``, else its numbers without the limits.  ``"last"``: the
    kernel path's last step's logits."""
    import torch
    from repro_torch.kernels import attention
    from repro_torch.kernels.cases import lm_logits_agreement
    L = LM_CLI["max_len"]
    kern, launches = _lm_steps(cfg, params, toks, L)
    if any(n != 2 * calls for n in launches):
        raise AssertionError(f"[lm] {cfg.name}: B4 launches per "
                             f"step {launches}")
    real = attention.decode_attention

    def plain(q, k, v, lengths, softcap=0.0, window=0):
        return attention.decode_attention_plain(q, k, v, lengths,
                                                softcap=softcap, window=window)
    attention.decode_attention = plain
    try:
        ref, plain_launches = _lm_steps(cfg, params, toks, L)
    finally:
        attention.decode_attention = real
    if any(plain_launches) or not bool(torch.isfinite(kern).all()):
        raise AssertionError(f"[lm] {cfg.name}: plain path launched "
                             f"{plain_launches} or kernel logits not finite")
    if held:
        out = lm_logits_agreement(kern, ref, f"[lm] {cfg.name}")
    else:
        k, r = kern.double(), ref.double()
        out = {"corr": min(float(torch.corrcoef(torch.stack(
                   [a.ravel(), b.ravel()]))[0, 1]) for a, b in zip(k, r)),
               "rel": float(max((a - b).abs().max() / b.abs().max()
                                for a, b in zip(k, r))),
               "agree": float((k.argmax(-1) == r.argmax(-1)).double().mean()),
               "held": False}
    out.update(steps=LM_CHECK_STEPS, dtype=cfg.dtype, last=kern[-1])
    return out


def _dropless(cfg):
    """A moe config whose capacity is the token count: no token dropped."""
    import dataclasses
    return dataclasses.replace(cfg,
                               moe_capacity_factor=cfg.n_experts / cfg.top_k)


def _decode_vs_prefill(cfg, params, toks, last) -> dict:
    """The last decode step's logits ``last`` against ``prefill_step`` over
    the same tokens, at the reference's bar (correlation > 0.99, top-1
    agreement >= 0.5).  A moe config is checked at its own capacity factor
    first: prefill drops the tokens past each expert's capacity, decode
    drops none, so where that bar fails the check is made again with a
    dropless prefill (capacity = the token count) and the run says so."""
    from repro_torch.models.serve import prefill_step

    def bar(c):
        full = prefill_step(params, c, {"tokens": toks})
        got, want = last.double().cpu().numpy(), full.double().cpu().numpy()
        return (float(np.corrcoef(got.ravel(), want.ravel())[0, 1]),
                float((got.argmax(-1) == want.argmax(-1)).mean()))
    corr, top1 = bar(cfg)
    out = {"steps": LM_CHECK_STEPS, "corr": corr, "top1": top1}
    if cfg.family == "moe":
        out["capacity_factor"] = cfg.moe_capacity_factor
        if not (corr > 0.99 and top1 >= 0.5):
            dropless = _dropless(cfg)
            out["at_capacity_factor"] = {"corr": corr, "top1": top1}
            corr, top1 = bar(dropless)
            out.update(corr=corr, top1=top1,
                       capacity_factor=dropless.moe_capacity_factor,
                       dropless_because=(
                           "at the config's capacity factor the prefill "
                           "drops tokens that decode keeps, and the bar "
                           "failed"))
    if not (corr > 0.99 and top1 >= 0.5):
        raise AssertionError(f"[lm] {cfg.name}: decode vs prefill "
                             f"correlation {corr}, top-1 {top1}")
    return out


# [train]: the train CLI at unionlm-100m's full width on UQ3 at the [uq3]
# scale (≈ TPC-H SF 1), then two profiled steps and a supervised restart
TRAIN_ARGV = ["--arch", "unionlm-100m", "--workload", "UQ3", "--scale",
              "100", "--batch", "16", "--seq", "1024", "--steps", "30",
              "--checkpoint-every", "10"]
# one smoke config of each of the seven families
TRAIN_PARITY_ARCHS = ("unionlm-100m", "gemma2-9b", "phi3.5-moe-42b-a6.6b",
                      "mamba2-780m", "zamba2-7b", "whisper-medium",
                      "paligemma-3b")
# the CPU tests' limits (tests/test_torch_train.py, tests/test_torch_train_
# families_step.py): float32 values, gradients (the optimizer slots), and
# the whole step (each parameter within 2·lr, at least 99.9 % of them
# within rtol 1e-4 and atol 1e-6).  The SSM smoke models' float32
# gradients are ill-conditioned: there the grad-norm and each slot within
# TRAIN_SPREAD_FACTOR × the reference's own float32 spread (its jitted
# against its eager gradients, worst tensor, relative to its largest
# value; twice that for v), and every parameter outside rtol 1e-4 one
# whose gradient is within that spread of 0 or within TRAIN_NEAR_EPS ×
# Adam's eps
TRAIN_F32 = {"rtol": 1e-4, "atol": 1e-4}
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 1e-4, 1e-5
TRAIN_STEP_RTOL, TRAIN_STEP_ATOL, TRAIN_STEP_SHARE = 1e-4, 1e-6, 0.999
TRAIN_F32_SPREAD = {"mamba2-780m": 1.44e-4, "zamba2-7b": 2.20e-4}
TRAIN_SPREAD_FACTOR, TRAIN_SPREAD_CORR, TRAIN_NEAR_EPS = 4.0, 0.99999, 100


def _numpy_params(cfg, seed: int) -> dict:
    """Parameters under the reference's law from a numpy generator."""
    from repro_torch.models.transformer import init_law, param_entries
    rng = np.random.default_rng(seed)
    out = {}
    for k, (shp, _) in param_entries(cfg).items():
        fan_in = shp[-2] if len(shp) >= 2 else shp[-1]
        out[k] = (np.zeros(shp, np.float32) if init_law(k, shp) == "zeros"
                  else (rng.standard_normal(shp) / np.sqrt(fan_in)
                        ).astype(np.float32))
    return out


def _train_parity(arch: str) -> dict:
    """One float32 train step of ``arch``'s smoke config from numpy
    parameters and batch (with frontend embeddings for encdec and vlm), on
    the card and on the CPU, held to the CPU tests' limits (loss,
    grad-norm and lr as values, the optimizer slots as gradients, the
    parameters under the whole-step limit; ``TRAIN_F32_SPREAD`` for the
    SSM models)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.interop import params_from_numpy
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_step import TrainConfig, make_train_step
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    tc = TrainConfig(opt=OptConfig(lr=1e-3), total_steps=10, warmup_steps=1)
    nparams = _numpy_params(cfg, seed=0)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(4, cfg.vocab, (2, 64)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab, (2, 64)).astype(np.int32)}
    if cfg.frontend != "none":
        batch["frontend"] = rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    spread = TRAIN_F32_SPREAD.get(arch)
    out = {}
    for dev in ("cpu", "cuda"):
        params = params_from_numpy(cfg, nparams, dev, dtype=torch.float32)
        state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
                 "params": params, "opt": init_opt_state(tc.opt, params)}
        state, metrics = make_train_step(cfg, tc)(state, {
            k: torch.as_tensor(v, device=dev) for k, v in batch.items()})
        out[dev] = (state, {k: float(v) for k, v in metrics.items()})
    (cs, cm), (gs, gm) = out["cpu"], out["cuda"]
    lim = None if spread is None else TRAIN_SPREAD_FACTOR * spread
    for k in ("loss", "grad_norm", "lr"):
        tol = ({"rtol": lim} if k == "grad_norm" and lim is not None
               else TRAIN_F32)
        np.testing.assert_allclose(gm[k], cm[k], err_msg=f"[train] {arch} {k}",
                                   **tol)
    worst, outside, unexplained, n = 0.0, 0, 0, 0
    for k, want in cs["params"].items():
        want = want.double().numpy()
        d = np.abs(gs["params"][k].cpu().double().numpy() - want)
        worst = max(worst, float(d.max()))
        off = d > TRAIN_STEP_ATOL + TRAIN_STEP_RTOL * np.abs(want)
        outside += int(off.sum())
        if lim is not None:
            m = np.abs(cs["opt"][f"m.{k}"].double().numpy())
            near0 = (m <= lim * m.max()) | (
                m / (1 - tc.opt.b1) <= TRAIN_NEAR_EPS * tc.opt.eps)
            unexplained += int((off & ~near0).sum())
        n += want.size
    if worst > 2 * cm["lr"] or unexplained or (
            lim is None and outside > (1 - TRAIN_STEP_SHARE) * n):
        raise AssertionError(f"[train] {arch}: card step differs from the "
                             f"CPU step: max {worst}, {outside} of {n} "
                             f"parameters outside ({unexplained} with a "
                             "gradient away from 0)")
    worst_slot = 0.0
    for k, want in cs["opt"].items():
        want = want.double().numpy()
        got = gs["opt"][k].cpu().double().numpy()
        rel = float(np.abs(got - want).max() / max(np.abs(want).max(),
                                                   1e-30))
        worst_slot = max(worst_slot, rel)
        if lim is None:
            np.testing.assert_allclose(
                got, want, rtol=TRAIN_GRAD_RTOL,
                atol=TRAIN_GRAD_ATOL * np.abs(want).max(),
                err_msg=f"[train] {arch} {k}")
            continue
        corr = (np.corrcoef(got.ravel(), want.ravel())[0, 1]
                if want.size > 1 and want.std() > 0 else 1.0)
        if rel > lim * (2 if k.startswith("v.") else 1) or \
                corr <= TRAIN_SPREAD_CORR:
            raise AssertionError(f"[train] {arch} {k}: card slot {rel} of "
                                 f"the largest from the CPU's, corr {corr}")
    return {"loss": [cm["loss"], gm["loss"]],
            "grad_norm": [cm["grad_norm"], gm["grad_norm"]],
            "param_max_abs_diff": worst, "params_outside": outside,
            "n_params": n, "slot_max_rel_diff": worst_slot}


def _cuda_events(fn):
    """The kernels and copies of one call of ``fn`` (torch.profiler with
    device activity only: a train step's ~10^4 host ops are not recorded),
    as (name, microseconds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    if not ev:
        raise AssertionError("torch.profiler recorded no device activity")
    return ev


def _profile_steps(step, state, batches):
    """Train steps over ``batches`` under a device-only profiler, then
    again without it for the wall: (the state after them, device ms, wall
    ms and busy share per step, kernels per step, cuBLAS's share and the
    costliest kernels)."""
    import torch
    box, n = [state], len(batches)
    del state                   # the box holds the one live state

    def steps():
        for b in batches:
            box[0], _ = step(box[0], b)
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev = _cuda_events(steps)
    prof_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    steps()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    dev_ms = sum(us for _, us in ev) / n / 1e3
    by_name: dict = {}
    for name, us in ev:
        by_name[name[:90]] = by_name.get(name[:90], 0.0) + us / n / 1e3
    # cuBLAS's kernels: sm80_xmma_gemm_* (float32) and nvjet_* (bf16 on
    # Hopper)
    gemm = [(nm, us) for nm, us in ev
            if any(t in nm for t in ("gemm", "xmma", "cutlass", "nvjet"))]
    return box[0], {
        "device_ms_per_step": dev_ms, "wall_ms_per_step": wall_ms,
        "device_busy_share": dev_ms / wall_ms,
        "device_events_per_step": len(ev) / n,
        "gemm_ms_per_step": sum(us for _, us in gemm) / n / 1e3,
        "f32_gemm_ms_per_step": sum(us for nm, us in gemm
                                    if "f32f32" in nm) / n / 1e3,
        "profiler_s": prof_s,
        "top_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6])}


def _uq1_pipeline(batches: int = 2) -> dict:
    """The train CLI's ``build_pipeline`` on UQ1 (scale ``SHARDS_SCALE``),
    whose weighted nodes run ``sorted_probe``: ``batches`` token batches at
    ``TRAIN_ARGV``'s shape with the launch counts set to 0 just before and
    read just after (both probes > 0)."""
    from repro_torch.kernels import build
    from repro_torch.launch.train import build_pipeline
    t0 = time.perf_counter()
    pipe = build_pipeline("UQ1", SHARDS_SCALE, 0, 16, 1024, 8192,
                          "histogram", False, "cuda")
    build_s = time.perf_counter() - t0
    build.reset_launch_counts()
    for _ in range(batches):
        pipe.next_batch()
    launches = _launches()
    _require_probes("train UQ1 pipeline", launches)
    return {"scale": SHARDS_SCALE, "batches": batches,
            "tuples": pipe.stats.tuples, "build_s": build_s,
            "sample_s": pipe.stats.sample_seconds, "launches": launches}


def _bits(t):
    import torch
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def _flat_leaves(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def phase_train(seed: int = 0) -> dict:
    """The train CLI's path on the card: (1) one float32 step of the smoke
    configs on the card against the CPU; (2) ``launch.train.main`` at
    ``TRAIN_ARGV`` (unionlm-100m at full width, UQ3 at scale 100, B 16, S
    1024, 30 steps) with the launch counts set to 0 just before and read
    just after: steady-state tokens/s (steps 2-30), the sampler's share,
    peak memory, the first and last loss (the last must be lower) and
    ``probe_pick`` > 0 (every UQ3 node is uniform: the path runs no
    ``sorted_probe``), then two batches of the same pipeline on UQ1
    (``_uq1_pipeline``: ``sorted_probe`` > 0); two more steps under the
    profiler (device ms, busy
    share, the costliest kernels); (3) a ``TrainSupervisor`` on the same
    pipeline with one failure injected right after its first checkpoint:
    exactly one restart, the target step (one past the checkpoint)
    reached, and the state restored from ``LATEST`` bit-equal to the state
    saved."""
    import shutil
    import torch
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.kernels import build
    from repro_torch.launch.ft import FTConfig, TrainSupervisor
    from repro_torch.launch.train import main as train_main
    t0 = time.perf_counter()
    out = {"parity": {a: _train_parity(a) for a in TRAIN_PARITY_ARCHS}}
    out["parity_s"] = time.perf_counter() - t0
    ckdir = os.path.join(HERE, "build", "train_ckpt")
    shutil.rmtree(ckdir, ignore_errors=True)
    try:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        t1 = time.perf_counter()
        res = train_main(TRAIN_ARGV + ["--checkpoint-dir", ckdir,
                                       "--device", "cuda"])
        out["launches"] = _launches()
        out["cli_s"] = time.perf_counter() - t1
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
        state, step, pipe = res["state"], res["train_step"], res["pipeline"]
        losses, step_s = res["losses"], res["step_seconds"]
        if out["launches"]["probe_pick"] <= 0:
            raise AssertionError("[train] the UQ3 pipeline launched no "
                                 "probe_pick")
        out["uq1_pipeline"] = _uq1_pipeline()
        if not losses[-1] < losses[0]:
            raise AssertionError(f"[train] loss did not fall: {losses[0]} -> "
                                 f"{losses[-1]}")
        tok = res["tokens_per_step"]
        out.update(
            steps=len(losses), tokens_per_step=tok,
            loss_first=losses[0], loss_last=losses[-1],
            first_step_s=step_s[0],
            steady_tokens_per_s=tok * (len(step_s) - 1) / sum(step_s[1:]),
            steady_step_ms=1e3 * sum(step_s[1:]) / (len(step_s) - 1),
            run_s=res["seconds"],
            run_tokens_per_s=tok * len(losses) / res["seconds"],
            sample_s=pipe.stats.sample_seconds,
            sampler_share_of_run=pipe.stats.sample_seconds / res["seconds"],
            sampler_share_of_step_wall=pipe.stats.sample_seconds / (
                pipe.stats.sample_seconds + sum(step_s)),
            tuples=pipe.stats.tuples, checkpoints=res["ft"].checkpoints,
            n_params=sum(t.numel() for t in state["params"].values()))

        # two steps under the profiler, on batches drawn before it
        batches = [{k: torch.as_tensor(v, device="cuda") for k, v in
                    zip(("tokens", "targets"), pipe.next_batch())}
                   for _ in range(2)]
        state, out["profile"] = _profile_steps(step, state, batches)

        # a supervised restart on the same pipeline
        ck = Checkpointer(os.path.join(ckdir, "restart"), keep=2)
        saved, restored = {}, {}
        real_save, real_restore = ck.save, ck.restore

        def save(s, st, pp=None):
            saved[s] = {k: _bits(v) for k, v in _flat_leaves(st).items()}
            return real_save(s, st, pp)

        def restore(s=None, device=None, verify=True):
            tree, pp = real_restore(s, device, verify)
            restored[s] = {k: _bits(v) for k, v in _flat_leaves(tree).items()}
            return tree, pp
        ck.save, ck.restore = save, restore
        s0 = int(state["step"])
        first_ck = s0 + 2 - s0 % 2            # checkpoint_every=2
        fired = []

        def inject(s):
            if s == first_ck and not fired:
                fired.append(s)
                raise RuntimeError("injected failure")

        def step_fn(st, batch):
            return step(st, {k: torch.as_tensor(v, device="cuda")
                             for k, v in zip(("tokens", "targets"), batch)})
        sup = TrainSupervisor(step_fn, pipe.next_batch, ck,
                              FTConfig(checkpoint_every=2),
                              pipeline_state_fn=pipe.state_dict,
                              restore_pipeline_fn=pipe.load_state_dict)
        t3 = time.perf_counter()
        target = first_ck + 1
        final = sup.run(state, target - s0, fail_injector=inject)
        torch.cuda.synchronize()
        if sup.stats.restarts != 1 or int(final["step"]) != target:
            raise AssertionError(f"[train] restart: {sup.stats}, step "
                                 f"{int(final['step'])} (target {target})")
        if list(restored) != [first_ck]:
            raise AssertionError(f"[train] restored {list(restored)}, not "
                                 f"step {first_ck}")
        a, b = saved[first_ck], restored[first_ck]
        if set(a) != set(b) or not all(torch.equal(a[k], b[k]) for k in a):
            raise AssertionError("[train] the restored state differs from "
                                 "the saved state")
        out["restart"] = {"from_step": s0, "target": target,
                          "restarts": sup.stats.restarts,
                          "restored_step": first_ck,
                          "leaves_bit_equal": len(a),
                          "checkpoints": sup.stats.checkpoints,
                          "seconds": time.perf_counter() - t3}
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    return out


# [train-families]: a model of each other family at its published width
# from random init on the card, 10 steps on UQ3 samples at scale 100 (the
# train CLI's pipeline), one model at a time: (arch, n_layers cut or None,
# B, S).  The state takes 16 B a parameter (float32 master, AdamW's two
# float32 slots, the compute-dtype copy and its gradient; the update is in
# place), ~18 B at the step's peak with the clipped gradients: a full-depth
# zamba2-7b (81 layers, 5.6 B parameters) or phi3.5-moe (32 layers, ~42 B)
# does not fit on 80 GB, so zamba2-7b runs 45 layers (7 of its 13 groups
# and the 3 tail SSM layers) and phi3.5-moe 2 (printed under "reduced")
TRAIN_FAMILIES = (("mamba2-780m", None, 8, 1024), ("zamba2-7b", 45, 4, 1024),
                  ("whisper-medium", None, 8, 448),
                  ("paligemma-3b", None, 4, 512),
                  ("phi3.5-moe-42b-a6.6b", 2, 4, 1024))
TRAIN_FAMILY_STEPS = 10


def _family_run(cfg, tc, pipe, fe, seed: int) -> dict:
    """``TRAIN_FAMILY_STEPS`` steps of ``cfg`` from a random state on the
    card over ``pipe``'s batches (+ the frontend ``fe``), timed as the
    train CLI times them (the step, its batch's upload and its loss read;
    the batch drawn before), then two profiled steps."""
    import torch
    from repro_torch.train.train_step import init_train_state, make_train_step
    state = init_train_state(cfg, tc, seed=seed, device="cuda")
    step = make_train_step(cfg, tc)

    def upload(toks, tgts):
        b = {"tokens": torch.as_tensor(toks, device="cuda"),
             "targets": torch.as_tensor(tgts, device="cuda")}
        if fe is not None:
            b["frontend"] = fe
        return b
    losses, step_s = [], []
    for _ in range(TRAIN_FAMILY_STEPS):
        toks, tgts = pipe.next_batch()
        t0 = time.perf_counter()
        state, m = step(state, upload(toks, tgts))
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
    return {"state": state, "train_step": step, "losses": losses,
            "step_seconds": step_s,
            "batches": [upload(*pipe.next_batch()) for _ in range(2)]}


def phase_train_families(seed: int = 0) -> dict:
    """``TRAIN_FAMILIES`` on the card: mamba2-780m through
    ``launch.train.main`` as a user runs it (B 8, S 1024, UQ3 at scale
    100), the others over the same sampler with a ``TokenEncoder`` at
    their vocab (whisper's 1,500 frames and paligemma's 256 patches from a
    seeded generator in the compute dtype, as ``[lm-families]`` stubs
    them).  For each: the launch counts set to 0 just before its steps and
    read just after (``probe_pick`` > 0), steady tokens/s (steps 2-10),
    device ms, busy share and kernels per step over two profiled steps,
    peak memory, the first and last loss (the last must be lower).  Each
    model is freed before the next is made."""
    import dataclasses
    import gc
    import shutil
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.encode import TokenEncoder
    from repro_torch.data.pipeline import UnionSamplePipeline
    from repro_torch.kernels import build
    from repro_torch.launch.train import main as train_main
    from repro_torch.models.transformer import param_entries
    from repro_torch.train.optimizer import OptConfig, default_opt_for
    from repro_torch.train.train_step import TrainConfig
    out, sampler = {}, None
    ckdir = os.path.join(HERE, "build", "train_families_ckpt")
    for arch, n_layers, B, S in TRAIN_FAMILIES:
        t0 = time.perf_counter()
        cfg = get_config(arch)
        full = cfg.n_layers
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fe = None
        if cfg.frontend != "none":
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed)
            fe = torch.randn((B, cfg.n_frontend_tokens, cfg.d_model),
                             generator=gen, device="cuda",
                             dtype=cfg.compute_dtype)
        build.reset_launch_counts()
        if sampler is None:
            shutil.rmtree(ckdir, ignore_errors=True)
            try:
                res = train_main([
                    "--arch", arch, "--workload", "UQ3", "--scale", "100",
                    "--batch", str(B), "--seq", str(S), "--steps",
                    str(TRAIN_FAMILY_STEPS), "--device", "cuda",
                    "--checkpoint-dir", ckdir])
            finally:
                shutil.rmtree(ckdir, ignore_errors=True)
            sampler, attrs = res["pipeline"].sampler, \
                res["pipeline"].encoder.attrs
            res["batches"] = [{k: torch.as_tensor(v, device="cuda")
                               for k, v in zip(("tokens", "targets"),
                                               res["pipeline"].next_batch())}
                              for _ in range(2)]
            pipe = res["pipeline"]
            via = "launch.train.main"
        else:
            tc = TrainConfig(opt=OptConfig(kind=default_opt_for(arch).kind),
                             warmup_steps=max(TRAIN_FAMILY_STEPS // 20, 2),
                             total_steps=TRAIN_FAMILY_STEPS)
            pipe = UnionSamplePipeline(
                sampler, TokenEncoder(attrs, vocab_size=cfg.vocab), batch=B,
                seq_len=S)
            res = _family_run(cfg, tc, pipe, fe, seed)
            via = "init_train_state + make_train_step"
        launches = _launches()
        losses, step_s = res["losses"], res["step_seconds"]
        if launches["probe_pick"] <= 0:
            raise AssertionError(f"[train-families] {arch}: the UQ3 pipeline "
                                 "launched no probe_pick")
        if not losses[-1] < losses[0]:
            raise AssertionError(f"[train-families] {arch}: loss did not "
                                 f"fall: {losses[0]} -> {losses[-1]}")
        tok = B * S
        # the run's state is handed over, not kept: one state fits, not two
        state, prof = _profile_steps(res.pop("train_step"), res.pop("state"),
                                     res.pop("batches"))
        row = {"arch": arch, "family": cfg.family, "via": via,
               "n_layers": cfg.n_layers, "d_model": cfg.d_model,
               "vocab": cfg.vocab, "batch": B, "seq": S,
               "frontend_tokens": cfg.n_frontend_tokens,
               "n_params": sum(math.prod(shp) for shp, _ in
                               param_entries(cfg).values()),
               "steps": len(losses), "loss_first": losses[0],
               "loss_last": losses[-1], "first_step_s": step_s[0],
               "steady_tokens_per_s": tok * (len(step_s) - 1)
               / sum(step_s[1:]),
               "steady_step_ms": 1e3 * sum(step_s[1:]) / (len(step_s) - 1),
               "sample_s": pipe.stats.sample_seconds,
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "launches": launches, "profile": prof}
        if n_layers is not None:
            row["reduced"] = f"{n_layers} of {full} layers"
        del state, res, pipe, fe
        row["wall_s"] = time.perf_counter() - t0
        out[arch] = row
        print(f"[train-families] {arch} " + json.dumps(row), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return out


# [model-sharding]: moe_ffn_dist at phi3.5-moe's MoE widths (float32), B 4
# x S 256, against moe_ffn with the same capacity: on a world-1 mesh in
# this process, then on two gloo ranks on the one card (model 2, each rank
# holding the whole tensors and running its 8 experts); compressed_psum on
# the same two ranks.  Outputs and gradients within MS_TOL of the largest
# value: CUDA's index_add_ and the sum over two ranks add in another order
MS_DIMS = {"d_model": 4096, "n_experts": 16, "top_k": 2, "d_ff": 6400}
MS_SHAPE = (4, 256)
MS_TOL = 1e-5


def _ms_inputs(seed: int = 0):
    """Weights of std 1/sqrt(fan_in), x and an output cotangent from a
    seeded generator on the card (the same on every rank)."""
    import torch
    from repro_torch.models.moe import moe_param_shapes, MoEDims
    dims = MoEDims(**MS_DIMS)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    params = {k: torch.randn(s, generator=gen, device="cuda")
              / math.sqrt(s[-2]) for k, s in moe_param_shapes(dims).items()}
    shape = MS_SHAPE + (dims.d_model,)
    x = torch.randn(shape, generator=gen, device="cuda")
    return dims, params, x, torch.randn(shape, generator=gen, device="cuda")


def _ms_grads(fn, params, x, ct):
    """(out, aux, gradients of sum(out · ct) + 0.01 · aux with respect to
    the four weights and x)."""
    import torch
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    xx = x.detach().requires_grad_(True)
    out, aux = fn(p, xx)
    g = torch.autograd.grad((out * ct).sum() + 0.01 * aux,
                            list(p.values()) + [xx])
    return out.detach(), aux.detach(), dict(zip(list(p) + ["x"], g))


def _rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _ms_rank(rank: int, port: int, results) -> None:
    """One of ``[model-sharding]``'s two ranks: a (data 1, model 2) mesh
    over gloo on the one card; ``moe_ffn_dist`` against ``moe_ffn`` (the
    world-1 result, computed here on the same inputs): the output, the aux
    and this rank's gradients of x and the four weights (each rank holds
    the whole gradient, as under the reference's ``shard_map``); then
    ``compressed_psum``."""
    import datetime
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        from repro_torch.launch.mesh import axis_group, make_mesh, set_mesh
        from repro_torch.models.moe import moe_ffn, moe_ffn_dist
        from repro_torch.train.grad_compress import compressed_psum
        mesh = make_mesh((1, 2), ("data", "model"))
        dims, params, x, ct = _ms_inputs()
        d_out, d_aux, d_g = _ms_grads(lambda p, v: moe_ffn(p, v, dims),
                                      params, x, ct)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with set_mesh(mesh):
            out, aux, g = _ms_grads(lambda p, v: moe_ffn_dist(p, v, dims),
                                    params, x, ct)
        torch.cuda.synchronize()
        res = {"dist_fwd_bwd_s": time.perf_counter() - t0,
               "out": _rel(out, d_out), "aux": _rel(aux, d_aux)}
        res.update({f"grad_{k}": _rel(g[k], d_g[k]) for k in d_g})
        del params, x, ct, d_g, g
        gen = torch.Generator(device="cuda")
        gen.manual_seed(10 + rank)
        c = torch.randn((1024, 1024), generator=gen, device="cuda") \
            * 10.0 ** rank
        got = compressed_psum(c, axis_group(mesh, "model"))
        exact = c.clone()
        dist.all_reduce(exact)
        both = torch.empty((2 * got.numel(),), device="cuda")
        dist.all_gather_into_tensor(both, got.reshape(-1))
        res["psum_err"] = float((got - exact).abs().max())
        res["psum_bar"] = float(0.05 * exact.abs().max() + 1e-5)
        res["psum_same_on_both"] = bool(torch.equal(both[:got.numel()],
                                                    both[got.numel():]))
        results.put((rank, res))
    except BaseException as e:
        results.put((rank, {"error": repr(e)}))
        raise
    finally:
        dist.destroy_process_group()


def phase_model_sharding(timeout: float = 150.0) -> dict:
    """``moe_ffn_dist`` on a world-1 mesh in this process (a one-rank gloo
    group over a ``HashStore``) and on two gloo ranks on the card, each
    against ``moe_ffn`` with the same capacity within ``MS_TOL``;
    ``compressed_psum`` on the two ranks within the reference's bar
    (``err ≤ 0.05·max|psum| + 1e-5``, ``tests/test_infra.py``)."""
    import socket
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp
    from repro_torch.launch.mesh import make_mesh, set_mesh
    from repro_torch.models.moe import moe_ffn, moe_ffn_dist
    t0 = time.perf_counter()
    out = {"dims": MS_DIMS, "shape": list(MS_SHAPE), "dtype": "float32"}
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        dims, params, x, ct = _ms_inputs()
        d_out, d_aux, d_g = _ms_grads(lambda p, v: moe_ffn(p, v, dims),
                                      params, x, ct)
        with set_mesh(mesh):
            w_out, w_aux, w_g = _ms_grads(
                lambda p, v: moe_ffn_dist(p, v, dims), params, x, ct)
        w1 = {"out": _rel(w_out, d_out), "aux": _rel(w_aux, d_aux)}
        w1.update({f"grad_{k}": _rel(w_g[k], d_g[k]) for k in d_g})
        with set_mesh(mesh):
            w1["dist_ms"] = _call_ms(lambda: moe_ffn_dist(params, x, dims),
                                     reps=10, warm=2)
        w1["dense_ms"] = _call_ms(lambda: moe_ffn(params, x, dims), reps=10,
                                  warm=2)
        out["world1"] = w1
        del params, x, ct, d_g, w_g, d_out, w_out
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    if any(v > MS_TOL for k, v in w1.items() if not k.endswith("_ms")):
        raise AssertionError(f"[model-sharding] world 1: {w1}")

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_ms_rank, args=(r, port, results))
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
        raise AssertionError(f"[model-sharding] ranks failed: exit codes "
                             f"{[p.exitcode for p in procs]}, {got}")
    for r, res in got.items():
        bad = [k for k, v in res.items()
               if (k in ("out", "aux") or k.startswith("grad_"))
               and v > MS_TOL]
        if bad or not res["psum_same_on_both"] or \
                res["psum_err"] > res["psum_bar"]:
            raise AssertionError(f"[model-sharding] rank {r}: {bad} {res}")
    out["world2_gloo"] = got
    out["wall_s"] = time.perf_counter() - t0
    return out


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


def _require_probes(label: str, launches: dict,
                    kernels=("sorted_probe", "probe_pick")) -> None:
    for k in kernels:
        if launches[k] <= 0:
            raise AssertionError(f"[{label}] kernel {k} was not launched")


# the kernels every round of a UQ1 engine launches: both probes, and
# member_lookup for each join after the first
ROUND_KERNELS = ("sorted_probe", "probe_pick", "member_lookup")


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
    _require_probes("replicas", launches, ROUND_KERNELS)
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
    """World 1 on ``wl`` (no process group, no collective), per plan: the
    sharded engine's device loop (``SetUnionSampler(mesh=make_sampler_mesh(
    world=1))``, the default, and the adaptive ``ShardedUnionSampler`` on
    the same ``ShardedCatalog``; one CUDA graph per capacity class), its host
    loop and the unsharded device loop, all from the same seed on the same
    backend: ``calls`` × ``sample(n)`` bit-equal in rows, homes,
    fingerprints and ``SamplerStats``, with the launch counts set to 0 just
    before the device-mode calls and read just after (and apart for the host
    mode).  Then the three engines' rates in turns on one state."""
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

    def sharded(plan, mode):
        return ShardedUnionSampler(scat, est.cover, seed=0,
                                   round_batch=round_batch,
                                   stats=SamplerStats(), plan=plan,
                                   fused_rounds=mode)

    for plan in ("static", "adaptive"):
        dev = meshed.engine if plan == "static" else sharded(plan, "device")
        host = sharded(plan, "host")
        plain = TorchUnionSampler(meshed.backend, est.cover, seed=0,
                                  round_batch=round_batch,
                                  stats=SamplerStats(), plan=plan)
        if (dev.fused_rounds, plain.fused_rounds) != ("device", "device"):
            raise AssertionError("[sharded] the device loop is not the "
                                 "default")
        torch.cuda.synchronize()
        build.reset_launch_counts()
        got = [dev.sample(n) for _ in range(calls)]
        launches = _launches()
        _require_probes(f"sharded {plan}", launches)
        chunks = [dev.last_chunks, dev.last_host_syncs]
        if dev.last_host_syncs != dev.last_chunks + 1 or not all(
                cb.graph is not None for cb in dev._buffers.values()):
            raise AssertionError(f"[sharded] {plan}: the device loop did not "
                                 "replay a captured graph per chunk")
        build.reset_launch_counts()
        want_host = [host.sample(n) for _ in range(calls)]
        host_launches = _launches()
        want = [plain.sample(n) for _ in range(calls)]
        # (a SampleSet's stats are the engine's running counters)
        for other, what in ((want_host, "the sharded host loop"),
                            (want, "the unsharded device loop")):
            if not (all(np.array_equal(a.matrix(), b.matrix())
                        and np.array_equal(a.home, b.home)
                        and np.array_equal(a.fingerprint, b.fingerprint)
                        for a, b in zip(got, other))
                    and got[-1].stats.as_dict() == other[-1].stats.as_dict()):
                raise AssertionError(f"[sharded] {plan}: the world-1 device "
                                     f"loop differs from {what}")
        check_membership(meshed, got[-1].rows, got[-1].home)

        def rate(engine, k=4):
            t0 = time.perf_counter()
            for _ in range(k):
                engine.sample(round_batch)
            torch.cuda.synchronize()
            return k * round_batch / (time.perf_counter() - t0)
        engines = (("unsharded device", plain), ("sharded device", dev),
                   ("sharded host", host))
        out[plan] = {"calls": calls, "n": n, "bit_equal": True,
                     "launches": launches, "host_launches": host_launches,
                     "last_call_chunks_syncs": chunks,
                     "capture_s": {str(C): t for C, t in
                                   sorted(dev.capture_seconds.items())},
                     "shard_piece_batches": list(dev.shard_piece_batches),
                     "psi": got[-1].stats.psi(),
                     "engine_samples_per_s_in_turns": [
                         [name, rate(e)]
                         for name, e in engines + engines[::-1]]}
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


def _fallback_seq() -> int:
    """The sequence number of the newest engine-fallback event (-1: none)."""
    from repro_torch import obs
    return max([e["seq"] for e in obs.fallback_events()], default=-1)


def _fallbacks_since(seq: int) -> list:
    from repro_torch import obs
    return [(e["reason"], e["join"]) for e in obs.fallback_events()
            if e["seq"] > seq]


def _dangling_copy(spec, big: int = 1 << 31):
    """``spec`` with one extra row in its last (leaf) relation whose edge
    key is ``big``: the row joins nothing, so the join's output is
    ``spec``'s, but the packed edge domain leaves int32, which is the
    reference's ``int32_domain`` degrade."""
    from repro_torch.core.joins import JoinNode, JoinSpec
    from repro_torch.core.relation import Relation
    leaf = spec.nodes[-1]
    cols = {a: np.concatenate([c, c[:1]])
            for a, c in leaf.relation.columns.items()}
    cols[leaf.edge_attrs[0]][-1] = big
    rel = Relation(f"{leaf.relation.name}#big", cols)
    return JoinSpec(spec.name, spec.nodes[:-1] + [JoinNode(
        leaf.alias, rel, leaf.parent, leaf.edge_attrs, leaf.kind)])


def phase_host_engine(wl, est, backend, n: int = 4096,
                      strict_n: int = 256, eo_n: int = 1024) -> dict:
    """The host engine and three of the reference's degrade paths on
    ``wl``, each run held to exactly the ``record_fallback`` events it
    expects:

    * the mixed union: ``wl`` with the join of its last cover piece of
      positive size given one dangling row at ``1 << 31``
      (``_dangling_copy``), so that join draws
      on the host (``int32_domain``), membership goes to the host oracle
      (``host_oracle``) and the other joins draw through B1/B2 on the card;
      two ``sample(n)`` calls of the host probe loop, launch counts set to 0
      just before and read just after;
    * ``strict_paper_loop`` over ``backend`` (``strict_paper_loop``): one
      candidate per selection, each drawn through B1/B2;
    * ``join_method="eo"`` on the device backend records ``join_method`` and
      raises; the host engine then draws EO with no event.

    Every row lies in its home piece and in no earlier one."""
    import warnings
    import torch
    from repro_torch.core.backends.numpy_backend import NumpyCandidateSource
    from repro_torch.core.backends.torch_backend import (TorchBackend,
                                                         TorchCandidateSource)
    from repro_torch.core.union_sampler import SetUnionSampler
    from repro_torch.kernels import build
    out = {}

    def expect(label, seq, want):
        got = _fallbacks_since(seq)
        if got != want:
            raise AssertionError(f"[host-engine] {label}: fallbacks {got}, "
                                 f"expected {want}")
        return [list(g) for g in got]

    # the mixed union
    bad = [name for name in est.cover.order
           if est.cover.piece_sizes[name] > 0][-1]
    joins = [_dangling_copy(j) if j.name == bad else j for j in wl.joins]
    seq = _fallback_seq()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as warned:
        warnings.simplefilter("always")
        mixed_be = TorchBackend(wl.cat, joins, device="cuda", seed=0)
        mixed = SetUnionSampler(wl.cat, joins, est.cover, seed=0,
                                backend=mixed_be)
        mixed.prober                        # the oracle is built lazily
    build_s = time.perf_counter() - t0
    if set(mixed_be.degraded) != {bad} or mixed.engine is not None:
        raise AssertionError("[host-engine] the mixed union did not degrade "
                             f"{bad!r} alone: {mixed_be.degraded}")
    kinds = {name: type(src).__name__ for name, src in mixed.sources.items()}
    if not (isinstance(mixed.sources[bad], NumpyCandidateSource) and all(
            isinstance(src, TorchCandidateSource)
            for name, src in mixed.sources.items() if name != bad)):
        raise AssertionError(f"[host-engine] mixed sources: {kinds}")
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    got = [mixed.sample(n) for _ in range(2)]
    dt = time.perf_counter() - t0
    launches = _launches()
    _require_probes("host-engine mixed", launches)
    check_membership(mixed, got[-1].rows, got[-1].home)
    homes = np.bincount(np.concatenate([g.home for g in got]),
                        minlength=len(mixed.order))
    if homes[mixed.order.index(bad)] <= 0:
        raise AssertionError(f"[host-engine] {bad!r} served no row")
    out["mixed"] = {
        "degraded": bad, "sources": kinds, "build_s": build_s,
        "warnings": sorted({str(w.message)[:60] for w in warned}),
        "calls": 2, "n": n, "seconds": dt, "samples_per_s": 2 * n / dt,
        "psi": got[-1].stats.psi(), "home_counts": homes.tolist(),
        "launches": launches,
        "fallbacks": expect("mixed union", seq, [("int32_domain", bad),
                                                 ("host_oracle", "")])}
    # strict_paper_loop over the card's sources
    seq = _fallback_seq()
    strict = SetUnionSampler(wl.cat, wl.joins, est.cover, seed=0,
                             backend=backend, strict_paper_loop=True)
    for src in strict.sources.values():
        src._buf = None     # rows [baselines] left: the run refills anew
    build.reset_launch_counts()
    t0 = time.perf_counter()
    ss = strict.sample(strict_n)
    dt = time.perf_counter() - t0
    launches = _launches()
    if strict.engine is not None or launches["probe_pick"] + \
            launches["sorted_probe"] <= 0:
        raise AssertionError("[host-engine] strict_paper_loop did not run "
                             "the host loop over the card's sources")
    check_membership(strict, ss.rows, ss.home)
    out["strict_paper_loop"] = {
        "n": strict_n, "seconds": dt, "samples_per_s": strict_n / dt,
        "iterations": ss.stats.iterations, "launches": launches,
        "fallbacks": expect("strict_paper_loop", seq,
                            [("strict_paper_loop", "")])}
    # EO: refused on the device (recorded), drawn by the host engine
    seq = _fallback_seq()
    try:
        TorchBackend(wl.cat, wl.joins, device="cuda", join_method="eo")
    except ValueError:
        pass
    else:
        raise AssertionError("[host-engine] the device backend ran EO")
    refused = expect("eo on the device", seq, [("join_method", "")])
    seq = _fallback_seq()
    t0 = time.perf_counter()
    eo = SetUnionSampler(wl.cat, wl.joins, est.cover, seed=0,
                         backend="numpy", join_method="eo")
    eo_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ss = eo.sample(eo_n)
    dt = time.perf_counter() - t0
    check_membership(eo, ss.rows, ss.home)
    out["eo"] = {"n": eo_n, "build_s": eo_build_s, "seconds": dt,
                 "samples_per_s": eo_n / dt, "psi": ss.stats.psi(),
                 "device_refused": refused,
                 "fallbacks": expect("eo on the host", seq, [])}
    return out


def _w2_rank(rank: int, port: int, scale: float, requests: int,
             samples: int, round_batch: int, results) -> None:
    """One rank of ``[sharded-w2]``: the serve CLI's sampler with
    ``shards=2`` over a gloo group on the one card (its default, the
    per-rank device loop, with its chunks and host syncs per call), then
    the host loop on the same mesh, and both rates in turns."""
    import datetime
    import torch
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    try:
        import hashlib
        from repro_torch.core.union_sampler import SetUnionSampler
        from repro_torch.kernels import build
        from repro_torch.launch.serve import build_sampler
        sampler, wl, est, _ = build_sampler("UQ1", scale, seed=0,
                                            device="cuda",
                                            round_batch=round_batch, shards=2)
        host = SetUnionSampler(wl.cat, wl.joins, est.cover, seed=0,
                               backend=sampler.backend,
                               round_batch=round_batch,
                               mesh=sampler.engine.mesh, fused_rounds="host")
        dev = sampler.engine
        if dev.fused_rounds != "device":
            raise AssertionError("the sharded engine's default is not the "
                                 "device loop")
        res = {"device": str(sampler.device)}
        for mode, s in (("device", sampler), ("host", host)):
            s.sample(256)
            torch.cuda.synchronize()
            build.reset_launch_counts()
            t0 = time.perf_counter()
            got, syncs = [], []
            for _ in range(requests):
                got.append(s.sample(samples))
                syncs.append([s.engine.last_chunks, s.engine.last_host_syncs])
            dt = time.perf_counter() - t0
            launches = _launches()
            if any(h != c + 1 for c, h in syncs):
                raise AssertionError(f"{mode}: host syncs != chunks + 1")
            mat = np.concatenate([np.concatenate(
                [g.matrix(), g.home[:, None]], axis=1) for g in got])
            check_membership(s, got[-1].rows, got[-1].home)
            res[mode] = {
                "seconds": dt, "samples_per_s": requests * samples / dt,
                "launches": launches, "rows": mat.shape[0],
                "chunks_syncs_per_call": syncs,
                "digest": hashlib.sha256(np.ascontiguousarray(
                    mat, np.int64).tobytes()).hexdigest()}
        # both loops' per-rank rates in turns (every rank runs the same
        # calls, so the collectives stay matched)
        turns = []
        for mode, s in (("device", sampler), ("host", host), ("host", host),
                        ("device", sampler)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(requests):
                s.sample(samples)
            torch.cuda.synchronize()
            turns.append([mode, requests * samples
                          / (time.perf_counter() - t0)])
        res["samples_per_s_in_turns"] = turns
        results.put((rank, res))
    except BaseException as e:
        results.put((rank, {"error": repr(e)}))
        raise
    finally:
        dist.destroy_process_group()


def phase_sharded_w2(scale: float, round_batch: int, requests: int = 4,
                     samples: int = 4096, timeout: float = 150.0) -> dict:
    """Two processes on the one card in a gloo group (NCCL refuses two
    ranks on one device): UQ1 at ``scale`` with ``shards=2``, ``requests``
    × ``sample(samples)`` on each rank, in the device loop and then the host
    loop.  In each loop both ranks must return the same rows (a digest of
    the whole stream) with their rows in their home pieces, one host sync
    per chunk plus the fetch, and both probes must launch on each."""
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
    for mode in ("device", "host"):
        a, b = got[0][mode], got[1][mode]
        if a["digest"] != b["digest"] or a["rows"] != requests * samples:
            raise AssertionError(f"[sharded-w2] {mode}: the ranks' streams "
                                 f"differ: {got}")
        for r in (a, b):
            _require_probes(f"sharded-w2 {mode}", r["launches"])
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


# the round's kernels' event names in a profiler trace, by launch-count key
PROBE_EVENTS = (("sorted_probe", "sorted_probe_kernel"),
                ("probe_pick", "probe_pick_kernel"),
                ("member_lookup", "member_lookup_kernel"))


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
            "device-loop", dev, round_batch, ROUND_KERNELS)
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
        _require_probes("device-loop", out["launches"], ROUND_KERNELS)
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


DRYRUN_CELLS = (("gemma2-9b", "decode_32k"), ("mamba2-780m", "decode_32k"),
                ("unionlm-100m", "train_4k"))


def phase_dryrun() -> dict:
    """``lower_cell`` at full width for three cells on a fake (16, 16)
    group: each step traced on meta tensors, its census extended from one
    and two blocks to the full depth.  B4 must appear in gemma2-9b's census
    exactly ``attention_calls_per_step`` times, and the traces must
    allocate nothing on the card and launch no kernel."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models.serve import attention_calls_per_step
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    launches0 = _launches()
    out = {}
    with dryrun.fake_mesh((16, 16), ("data", "model")) as mesh:
        for arch, shape in DRYRUN_CELLS:
            res = dryrun.lower_cell(arch, shape, mesh)
            r = res["roofline"]
            out[f"{arch} {shape}"] = {
                "trace_s": res["trace_s"], "depth": res["depth"],
                "partitioning": res["partitioning"],
                "argument_gib": res["memory"]["argument_bytes"] / 2**30,
                "kernel_calls": res["kernel_calls"],
                "collectives": res["collectives"],
                **{k: r[k] for k in (
                    "compute_s", "memory_s", "memory_census_floor_s",
                    "memory_upper_s", "collective_s", "dominant",
                    "model_flops_per_chip", "hlo_flops_per_chip",
                    "useful_flops_ratio", "params_total")}}
    calls = out["gemma2-9b decode_32k"]["kernel_calls"].get(
        "repro_torch.decode_attention", 0)
    want = attention_calls_per_step(get_config("gemma2-9b"))
    if calls != want:
        raise AssertionError(f"[dryrun] B4 in gemma2-9b's census {calls} "
                             f"times, not {want}")
    torch.cuda.synchronize()
    mem1, launches1 = torch.cuda.memory_allocated(), _launches()
    if mem1 != mem0 or launches1 != launches0:
        raise AssertionError(f"[dryrun] the traces touched the card: "
                             f"memory {mem0} -> {mem1}, launches "
                             f"{launches0} -> {launches1}")
    return {"cells": out, "b4_calls_gemma2": calls,
            "memory_allocated_delta": mem1 - mem0,
            "launches_delta": {k: launches1[k] - launches0[k]
                               for k in launches1}}


def phase_audits() -> dict:
    """The capture audit on the card (UQ1 static and adaptive: one static
    buffer set and one CUDA-graph capture per capacity class over sizes
    200, 300, 1400, 1500, 300, with the launch counts set to 0 just before
    and read just after), then the whole gate as a user runs it (``python
    -m repro_torch.analysis``: the lint, and the trace and capture audits
    on the card, its default device).  Any finding fails the run."""
    from repro_torch.analysis.recompile import audit_recompile_engine
    from repro_torch.analysis.trace_audit import build_engine
    from repro_torch.kernels import build
    out = {}
    for plan in ("static", "adaptive"):
        eng = build_engine("uq1", plan, device="cuda")
        build.reset_launch_counts()
        findings, report = audit_recompile_engine(eng, f"uq1-{plan}")
        report["launches"] = _launches()
        if findings or not report["graphs"] or report["captures"] != len(
                report["capacity_classes"]):
            raise AssertionError(f"[audits] {plan}: "
                                 f"{[f.render() for f in findings]} {report}")
        _require_probes(f"audits {plan}", report["launches"])
        out[plan] = report
    t0 = time.perf_counter()
    gate = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=os.path.join(HERE, "src")))
    if gate.returncode != 0:
        raise AssertionError(f"[audits] gate exit {gate.returncode}: "
                             f"{gate.stdout[-2000:]}{gate.stderr[-2000:]}")
    stats = json.loads(gate.stdout)["stats"]
    if not stats["audits"] or not all(
            r["device"].startswith("cuda") and r.get("graphs", True)
            for r in stats["audits"]):
        raise AssertionError(f"[audits] the gate's audits did not run on "
                             f"the card: {stats['audits']}")
    out["gate"] = {"rc": gate.returncode, "active": stats["active"],
                   "suppressed": stats["suppressed"],
                   "stale_baseline": stats["stale_baseline"],
                   "audits": len(stats["audits"]),
                   "wall_s": time.perf_counter() - t0}
    return out


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

    # wall seconds of each phase, printed on the [phases] line; a phase
    # that records an engine fallback fails the run ([host-engine] consumes
    # the ones it expects, and only those)
    marks = [("start", time.perf_counter())]
    fallback_seq = [_fallback_seq()]

    def mark(label):
        marks.append((label, time.perf_counter()))
        got = _fallbacks_since(fallback_seq[0])
        if got:
            raise AssertionError(f"[{label}] recorded engine fallbacks: "
                                 f"{got}")

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
                        args.round_batch, ROUND_KERNELS,
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

    # B5 at UQ1's and Q5's last probing join, on a real round's inputs
    member_row = {"name": "member_lookup", "route": "cuda",
                  "source": "src/repro_torch/kernels/csrc/member.cu",
                  "replaces": "src/repro/core/backends/jax_backend.py:610",
                  "path": "UQ1 main path",
                  "launches": main_out["launches"]["member_lookup"],
                  "launches_by_path": {
                      "UQ1 static": main_out["launches"]["member_lookup"]}}
    member_row.update(phase_member_lookup(main_sampler, args.round_batch))
    member_row["node"] = f"UQ1 join {len(main_sampler.order) - 1}"
    q5 = phase_member_q5(args.round_batch)
    member_row.update({"q5_" + k: v for k, v in q5.items()
                       if k not in ("ptxas",)})
    rows.append(member_row)
    print("[member-lookup] " + json.dumps(member_row), flush=True)
    mark("member-lookup")

    def path_launches(label, out):
        for r in rows:
            if r["name"] in ROUND_KERNELS:
                r["launches_by_path"][label] = out["launches"].get(
                    r["name"], 0)

    # 5. the adaptive round planner on the same UQ1 state, served the same
    from repro_torch.core.union_sampler import SetUnionSampler
    t0 = time.perf_counter()
    ad_sampler = SetUnionSampler(wl1.cat, wl1.joins, est1.cover, seed=0,
                                 device="cuda", round_batch=args.round_batch,
                                 plan="adaptive")
    ad_out = run_path("adaptive", "UQ1", args.scale, args.requests,
                      args.samples, args.round_batch, ROUND_KERNELS,
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
    shape_rows = phase_attention_shapes(seed=0)
    rows.extend(shape_rows)
    print("[ops] decode attention at the configs' shapes, kernel vs plain, "
          "ms / bound / SDPA: " + json.dumps(
              {r["name"]: [r["max_abs_err"], r["ms"], r["bound_ms"],
                           r["library_ms"]] for r in shape_rows}), flush=True)
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
    for plan in ("static", "adaptive"):
        path_launches(f"UQ1 sharded device {plan}", sh_out[plan])
        path_launches(f"UQ1 sharded host {plan}",
                      {"launches": sh_out[plan]["host_launches"]})
    print("[sharded] " + json.dumps(sh_out), flush=True)
    mark("sharded")
    he_out = phase_host_engine(wl1, est1, backend1)
    fallback_seq[0] = _fallback_seq()       # its own, checked in the phase
    path_launches("UQ1 host-engine mixed union", he_out["mixed"])
    path_launches("UQ1 strict_paper_loop", he_out["strict_paper_loop"])
    print("[host-engine] " + json.dumps(he_out), flush=True)
    mark("host-engine")
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
    path_launches("UQ1 sharded world 2 device (rank 0)",
                  w2_out["ranks"][0]["device"])
    path_launches("UQ1 sharded world 2 host (rank 0)",
                  w2_out["ranks"][0]["host"])
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

    # 12. LM serving at full width from random weights: B4 on every decode
    # attention of the served path
    lm_out = {}
    for arch in LM_ARCHS:
        lm_out[arch] = phase_lm(arch)
        print(f"[lm] {arch} " + json.dumps(lm_out[arch]), flush=True)
    print("[lm] smoke CLI " + json.dumps(phase_lm_cli()), flush=True)
    mark("lm")
    att_row = next(r for r in rows if r["name"] == "decode_attention")
    att_row["launches_by_path"] = {"[ops]": att_row["launches"]} | {
        f"[lm] {a} serve_lm": lm_out[a]["serve_lm"]["b4_launches"]
        for a in LM_ARCHS}
    att_row["launches"] = lm_out["gemma2-9b"]["serve_lm"]["b4_launches"]
    att_row["path"] = "[lm] gemma2-9b serve_lm at the CLI's defaults"
    att_row["launches_per_decode_step"] = {
        a: lm_out[a]["b4_launches_per_step"] for a in LM_ARCHS}

    # 12b. the other families at full width: B4 on four more served paths
    fam_out = {}
    for arch, n_layers, calls in FAMILY_ARCHS:
        fam_out[arch] = phase_lm_family(arch, n_layers, calls)
        print(f"[lm-families] {arch} " + json.dumps(fam_out[arch]),
              flush=True)
    print("[lm-families] smoke CLI " + json.dumps(phase_lm_cli("zamba2-7b")),
          flush=True)
    mark("lm-families")
    for arch, _, _ in FAMILY_ARCHS:
        sl = fam_out[arch]["serve_lm"]
        att_row["launches_by_path"][f"[lm-families] {arch} serve_lm"] = \
            sl["b4_launches"]
        att_row["launches_per_decode_step"][arch] = sl["b4_launches_per_step"]

    # 13. training at unionlm-100m's full width on UQ3 samples
    train_out = phase_train()
    print("[train] " + json.dumps(train_out), flush=True)
    mark("train")
    path_launches("[train] unionlm-100m UQ3", train_out)
    path_launches("[train] UQ1 pipeline (scale 1)", train_out["uq1_pipeline"])

    # 14. the other families' training at their published widths on UQ3
    # samples, then model sharding
    fam_train = phase_train_families()
    mark("train-families")
    for arch, row in fam_train.items():
        path_launches(f"[train-families] {arch} UQ3", row)
    ms_out = phase_model_sharding()
    print("[model-sharding] " + json.dumps(ms_out), flush=True)
    mark("model-sharding")

    # 16. the dry-run's census on three traced steps, then the audits
    dry_out = phase_dryrun()
    att_row["dryrun_census_calls"] = {
        "gemma2-9b decode_32k": dry_out["b4_calls_gemma2"]}
    print("[dryrun] " + json.dumps(dry_out), flush=True)
    mark("dryrun")
    aud_out = phase_audits()
    for plan in ("static", "adaptive"):
        path_launches(f"[audits] UQ1 {plan} (scale 0.02)", aud_out[plan])
    print("[audits] " + json.dumps(aud_out), flush=True)
    mark("audits")

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
