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
   piece batch of queries) and on edge sweeps, exact equality; CUDA-event
   times of kernel, plain version and ``torch.searchsorted``, and the bound;
3. draw parity — every UQ1 ``TorchTreeJoin`` draws identically through the
   kernels and through the plain versions on the same uniforms;
4. main path — ``SetUnionSampler(backend="torch", device="cuda")`` on UQ1
   served through ``SampleService`` (one warm-up request, then 16 × 4096),
   with launch counts (> 0 for both kernels), rate, ψ, rounds, host syncs,
   peak memory; served rows are members of their home piece and of no
   earlier piece (checked on the host against the base relations, sharing
   no code with the engine), and home frequencies follow the cover's
   selection law;
5. residual path — UQ4 (the §8.2 residual node runs ``probe_pick``);
6. small-input reference — UQ1 at scale 0.05 is sampled uniformly over its
   exact union (chi-square), on the card.

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


def _device_events(fn, reps: int):
    """The device activity (kernels, copies) of ``reps`` calls of ``fn``,
    from torch.profiler: a list of (name, microseconds)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ev = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
          if e.device_type == DeviceType.CUDA]
    if not ev:
        raise AssertionError("torch.profiler recorded no device activity")
    return ev


def _device_ms(fn, reps: int = 100, warm: int = 10) -> float:
    """Device time per call: the summed durations of every kernel the call
    launches (profiler), independent of the host's launch overhead."""
    for _ in range(warm):
        fn()
    return sum(us for _, us in _device_events(fn, reps)) / reps / 1e3


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
    """Kernel vs plain on the edge cases; returns the number of cases."""
    import torch
    from repro_torch.kernels import probe
    rng = np.random.default_rng(0)
    cases = [
        (np.repeat(np.arange(5), 200), np.arange(-1, 7)),         # runs
        (np.zeros(0, np.int64), np.array([-1, 0, 5])),             # empty keys
        (np.sort(rng.integers(100, 200, 300)),
         np.array([-5, 0, 99, 100, 150, 199, 200, 10**6])),         # outside
        (np.sort(rng.integers(-2**45, 2**45, 5000)),
         rng.integers(-2**46, 2**46, 3000)),                        # int64
        (np.array([7]), np.array([6, 7, 8])),                       # d = 0, 1
        (np.sort(rng.integers(0, 1000, 1 << 20)),
         rng.integers(-10, 1010, 100_000)),                         # large
    ]
    for keys, qs in cases:
        dts = [torch.int64]
        if keys.size == 0 or np.abs(np.concatenate([keys, qs])).max() < 2**31:
            dts.append(torch.int32)
        for dt in dts:
            k = torch.as_tensor(np.asarray(keys, np.int64), device="cuda").to(dt)
            q = torch.as_tensor(np.asarray(qs, np.int64), device="cuda").to(dt)
            u = torch.rand(q.shape[0], device="cuda")
            u[:1] = float(np.nextafter(np.float32(1), np.float32(0)))
            _check_equal(probe.sorted_probe(k, q), probe.sorted_probe_plain(k, q),
                         f"sorted_probe edge case n={k.numel()} {dt}")
            _check_equal(probe.probe_pick(k, q, u),
                         probe.probe_pick_plain(k, q, u),
                         f"probe_pick edge case n={k.numel()} {dt}")
    torch.cuda.synchronize()
    return len(cases)


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
    ``probe_pick`` sees; ``sorted_probe`` is timed there too)."""
    import torch
    from repro_torch.kernels import probe
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
        row["kernel_ms"] = row["ms"]
        row["bound_us"] = bound_ms * 1e3
        out.append(row)
    return out


def phase_draw_parity(sampler, batch: int) -> int:
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


def check_membership(sampler, rows, home) -> None:
    """Each sample lies in its home piece and in no earlier cover piece,
    by the definition of a join: a row is in a join iff its projection onto
    every base relation of the join is a row of that relation."""
    by_name = {j.name: j for j in sampler.joins}
    mm = np.stack([np.logical_and.reduce([_rows_in_relation(n.relation, rows)
                                          for n in by_name[name].nodes])
                   for name in sampler.order], axis=1)
    if not mm.any(axis=1).all():
        raise AssertionError("a served row is in no join of the union")
    first = np.argmax(mm, axis=1)
    if not np.array_equal(first, home):
        raise AssertionError(f"{int((first != home).sum())} served rows are "
                             "credited to the wrong cover piece")


def run_path(label: str, workload: str, scale: float, requests: int,
             samples: int, round_batch: int, required, before_serve=None
             ) -> dict:
    """Build, then serve through SampleService with the launch counts set
    to 0 just before and read just after (each kernel in ``required`` must
    have launched); check what came out.  Returns the summary
    (``sampler`` included)."""
    import torch
    from repro_torch.kernels import probe
    from repro_torch.launch.serve import build_sampler, serve
    sampler, wl, est, build_s = build_sampler(workload, scale, seed=0,
                                              device="cuda",
                                              round_batch=round_batch)
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
    out["sampler"] = sampler
    return out


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


def phase_small_reference(seed: int = 0) -> float:
    """UQ1 at scale 0.05: the card's samples are uniform over the exact
    union (chi-square p-value returned; must exceed 1e-3)."""
    from scipy import stats as sps
    from repro_torch.core.framework import estimate_union, warmup
    from repro_torch.core.overlap import exact_union_size
    from repro_torch.core.union_sampler import SetUnionSampler
    from repro_torch.data.workloads import uq1
    wl = uq1(scale=0.05, overlap=0.4, seed=seed)
    est = estimate_union(warmup(wl.cat, wl.joins, method="exact").oracle)
    U = exact_union_size(wl.cat, wl.joins)
    s = SetUnionSampler(wl.cat, wl.joins, est.cover, seed=7, device="cuda",
                        round_batch=1024)
    N = 200 * U
    ss = s.sample(N)
    m = ss.matrix()
    uni, counts = np.unique(m.view([("", m.dtype)] * m.shape[1]).ravel(),
                            return_counts=True)
    if uni.shape[0] > U:
        raise AssertionError("sampled tuples outside the union")
    exp = N / U
    chi2 = float(((counts - exp) ** 2 / exp).sum()) + (U - uni.shape[0]) * exp
    p = float(1 - sps.chi2.cdf(chi2, df=U - 1))
    check_membership(s, ss.rows, ss.home)
    if p <= 1e-3:
        raise AssertionError(f"UQ1 small-input chi-square failed (p={p})")
    return p


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=100.0,
                    help="UQ1 scale (100 ≈ TPC-H SF 1)")
    ap.add_argument("--uq4-scale", type=float, default=10.0)
    ap.add_argument("--round-batch", type=int, default=8192)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--samples", type=int, default=4096)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    from repro_torch.kernels import build, probe

    # 1. device and build
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
    prof = phase_profile(main_out.pop("sampler"), args.round_batch,
                         args.round_batch / main_out["engine_samples_per_s"])
    for r in rows:
        r["launches"] = main_out["launches"][r["name"]]
    print("[main] " + json.dumps(main_out), flush=True)
    print("[profile] " + json.dumps(prof), flush=True)

    # 5. residual path
    # UQ4 has no weighted node: its tree and residual hops all run probe_pick
    res_out = run_path("residual", "UQ4", args.uq4_scale, 4, args.samples,
                       args.round_batch, ("probe_pick",))
    res_out.pop("sampler")
    print("[residual] " + json.dumps(res_out), flush=True)

    # 6. small-input reference on the card
    p = phase_small_reference()
    print(f"[reference] UQ1 scale 0.05 uniform over the exact union on the "
          f"card: chi-square p={p:.4f}", flush=True)

    if args.scale != 100.0 or args.uq4_scale != 10.0:
        print(f"[cut] UQ1 scale {args.scale} (full: 100), UQ4 scale "
              f"{args.uq4_scale} (full: 10)", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
