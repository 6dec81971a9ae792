#!/usr/bin/env python3
"""Kernels and device time of one replayed round of a benchmark cell, with
the round's earlier-piece lookup as ``member_lookup`` and with its plain
version forced.

    python3 scripts/member_census.py --workload q5-sf1.stream \\
        --seed 7330000001 --calls 40 --out build/census

From the root of a checkout, on the card.  Builds the cell's program as the
benchmark does (its configuration, seeded inputs, warm-up and cover) and
two engines of that union with the same seed: the program's own, and one
whose lookups run ``member_lookup_plain`` (forced before its first capture;
the first engine's graph is captured by then).  Both serve calls of the
service batch in turns, ``--calls`` each, untraced, and must return the
same rows, homes and stats; then one call of each runs under
``torch.profiler``.  Prints one JSON line (also written to
``<out>/<cell>.jsonl`` with ``--out``): per engine the samples/s of its
calls, the rounds replayed in the profiled call, the kernels a replayed
round launched (profiler events over rounds replayed, in all and by
``unionbench.profiling.family``), device ms a round, and
``member_lookup``'s launches a round, µs a launch and its byte bound.
Without a CUDA card it exits with 2.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

HBM_BYTES_PER_S = 3.35e12


def _profile(sampler, n: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from unionbench.profiling import family
    torch.cuda.synchronize()
    eng = sampler.engine
    before = sampler.stats.member_lookups
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sampler.sample(n)
        torch.cuda.synchronize()
    rounds = eng.last_rounds + eng.last_wasted_rounds
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    fams, n_member, t_member, t_all = {}, 0, 0.0, 0.0
    for e in events:
        us = e.time_range.elapsed_us()
        t_all += us
        if "member_lookup" in e.name:
            n_member += 1
            t_member += us
        f = "member_lookup" if "member_lookup" in e.name else family(e.name)
        fams[f] = fams.get(f, 0) + 1
    return {"rounds_replayed": rounds, "events": len(events),
            "kernels_per_round": len(events) / max(rounds, 1),
            "by_family_per_round": {k: v / max(rounds, 1)
                                    for k, v in sorted(fams.items())},
            "device_ms_per_round": t_all / 1e3 / max(rounds, 1),
            "member_lookup_launches_per_round": n_member / max(rounds, 1),
            "member_lookup_us": t_member / max(n_member, 1),
            "member_lookups": sampler.stats.member_lookups - before}


def _bound_us(sampler, lookups: int, launches: int) -> float:
    """Least bytes of the profiled call's launches over the HBM rate, per
    launch: each launch's live mask and verdicts (1 B each a candidate),
    and per lookup, a (live candidate, earlier piece) pair, every relation
    of the piece: the columns it reads (4 B each) and the salt-1 and
    salt-2 entries of its hit (16 B), all read once.  A lookup's bytes are
    averaged over the earlier pieces of every probing join."""
    eng = sampler.engine
    pieces = len(eng.order)
    per_piece = []
    for j in range(1, pieces):
        for rels in eng._member_plan(j).pieces:
            per_piece.append(sum(4 * len(r[0]) + 16 for r in rels))
    avg = sum(per_piece) / max(len(per_piece), 1)
    cands = sum(eng.piece_batches[1:]) / max(pieces - 1, 1)
    per_launch = 2 * cands + avg * lookups / max(launches, 1)
    return 1e6 * per_launch / HBM_BYTES_PER_S


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=40)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("member_census: needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, member
    from unionbench import harness, inputs, program

    build.load()
    bench = harness.spec(ROOT)
    entry = harness.cell_entry(bench, args.workload)
    config = harness.load_json(ROOT / "unionbench" / "configs"
                               / f"{entry['config']}.json")
    dev = torch.device("cuda", 0)
    union = inputs.build(config, args.seed)
    cat, joins = program.specs(union)
    cov = program.cover(config, cat, joins, args.seed, dev)
    n = int(config["service"]["batch"])
    kern = program.set_union_sampler(config, cat, joins, cov, args.seed, dev)
    kern.sample(n)
    real = member.member_lookup
    member.member_lookup = member.member_lookup_plain
    try:
        plain = program.set_union_sampler(config, cat, joins, cov, args.seed,
                                          dev)
        plain.sample(n)
    finally:
        member.member_lookup = real
    out = {"cell": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(dev), "calls": args.calls,
           "same_rows": True}
    secs = {"kernel": 0.0, "plain": 0.0}
    for _ in range(args.calls):
        for name, s in (("kernel", kern), ("plain", plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = s.sample(n)
            torch.cuda.synchronize()
            secs[name] += time.perf_counter() - t0
            if name == "kernel":
                a = got
            else:
                same = (all(np.array_equal(a.rows[c], got.rows[c])
                            for c in a.attrs)
                        and np.array_equal(a.home, got.home))
                out["same_rows"] = out["same_rows"] and bool(same)
    out["same_stats"] = kern.stats.as_dict() == plain.stats.as_dict()
    for name, s in (("kernel", kern), ("plain", plain)):
        prof = _profile(s, n)
        prof["samples_per_s"] = args.calls * n / secs[name]
        prof["capture_s"] = float(sum(s.engine.capture_seconds.values()))
        out[name] = prof
    k = out["kernel"]
    launches = k["member_lookup_launches_per_round"] * k["rounds_replayed"]
    k["member_lookup_bound_us"] = _bound_us(kern, k["member_lookups"],
                                            int(round(launches)))
    k["member_lookups_per_launch"] = k["member_lookups"] / max(launches, 1)
    out["plain_member_ms_per_round"] = (
        out["plain"]["device_ms_per_round"] - k["device_ms_per_round"]
        + k["member_lookup_us"] * k["member_lookup_launches_per_round"] / 1e3)
    log = build.build()["log"].splitlines()
    out["member_lookup_ptxas"] = [
        ln.strip() for i, ln in enumerate(log)
        if any("member_lookup_kernel" in x for x in log[max(i - 2, 0):i + 1])]
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        d = pathlib.Path(args.out)
        d.mkdir(parents=True, exist_ok=True)
        with open(d / f"{args.workload}.jsonl", "a") as f:
            f.write(line + "\n")
    return 0 if out["same_rows"] and out["same_stats"] else 1


if __name__ == "__main__":
    sys.exit(main())
