r"""Serving CLI of the port: LM decode (``--mode lm``, the default) and
union samples (``--mode samples``), on the card unless ``--device cpu``.

``--mode lm`` serves greedy decoding with continuous batching: a fixed pool
of ``--slots`` decode slots, each holding one request of the queue
(``--requests`` random prompts of 2-5 tokens from ``--seed``); a slot first
consumes its prompt one token per step, then emits greedy tokens until
``--max-new`` or ``--max-len`` - 1, and is refilled from the queue.  The
model starts from random weights (``init_params(cfg, seed)``); ``--arch``
takes every id of :mod:`repro_torch.configs` (all seven families),
``--smoke`` its reduced config.  Every decode attention runs the B4 kernel
on the card (mamba2 has none)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm --smoke \
        --arch whisper-medium --device cpu --requests 2 --max-new 4 --slots 2

It prints the reference's two lines: requests served, decode steps,
seconds, steps/s and the batch, then the first tokens of up to four
requests.

``--mode samples`` serves uniform union samples through the streaming
:class:`repro_torch.serve.SampleService` (prefetched sample queue + request
batching) over the torch engine::

    PYTHONPATH=src python -m repro_torch.launch.serve --mode samples \
        --workload UQ1 --requests 16 --samples 4096
    PYTHONPATH=src python -m repro_torch.launch.serve --mode samples \
        --device cpu --scale 0.05 --requests 2 --samples 256
    PYTHONPATH=src python -m repro_torch.launch.serve --mode samples \
        --workload UQ2 --plan adaptive

``--workload UQ2`` builds the §8.3 predicate workload in its default
pushdown mode; ``--plan adaptive`` runs the adaptive round planner.
``--backend numpy`` serves from the host engine (the reference's default
backend, its exact batched probe loop; no device) instead of the default
``torch`` engine::

    PYTHONPATH=src python -m repro_torch.launch.serve --mode samples \
        --backend numpy --scale 0.05 --requests 2 --samples 256

``--shards N`` runs the sharded engine of :mod:`repro_torch.core.sharding`
(0, the default, is unsharded): ``--shards 1`` in this process; ``N > 1``
needs a process group of N ranks, so run it under torchrun, which starts
the N processes (one card each), whose group this CLI initialises
(``nccl`` on the card, ``gloo`` with ``--device cpu``)::

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --mode samples \
        --workload UQ1 --shards 4

Every rank serves the same samples; rank 0 prints.

It prints the served rate, ψ (candidate draws per emitted sample), rounds,
host syncs, the engine's round loop (``fused_rounds="device"``: one CUDA
graph per capacity class, one host sync per chunk of rounds; at
``--shards N > 1`` the same step runs eagerly in chunks) and the request
latency's p50/p99.  ``--metrics-port P`` starts a background HTTP thread with
``/metrics`` (Prometheus text: the engine's per-piece counters, rounds and
samples, the request-latency histogram with p50/p99, queue depth,
per-replica engine stats) and ``/healthz`` (``P=0`` binds an ephemeral
port, printed at startup); ``--linger S`` keeps the service and the
endpoint up S seconds after the requests so external scrapers can
collect::

    PYTHONPATH=src python -m repro_torch.launch.serve --mode samples \
        --device cpu --scale 0.05 --requests 2 --samples 256 \
        --metrics-port 0 --linger 5
"""

from __future__ import annotations

import argparse
import contextlib
import time
from typing import Dict, List, Optional

import numpy as np


def serve_lm(cfg, params, *, slots: int = 4, requests: int = 8,
             max_new: int = 16, max_len: int = 64, seed: int = 0,
             device=None) -> Dict[str, object]:
    """Greedy decoding of ``requests`` random prompts (2-5 tokens in
    ``[4, vocab)`` from ``numpy.random.default_rng(seed)``) with continuous
    batching over ``slots`` decode slots and caches of ``max_len``, as the
    reference's ``--mode lm`` loop: a slot starts from BOS (1) at length 0,
    consumes its prompt one token per step, then appends the ``argmax`` of
    each step's float32 logits (the first maximum) until it has ``max_new``
    tokens or its length reaches ``max_len - 1``, and is refilled from the
    queue.  Prints the reference's two lines and returns ``{"done": [(id,
    tokens)], "steps", "seconds", "steps_per_s", "tokens_per_s"}``
    (tokens: the greedy tokens emitted)."""
    import torch

    from ..device import resolve_device
    from ..models.serve import decode_step, init_cache

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    B = slots
    cache = init_cache(cfg, B, max_len, device=dev)
    # request queue: (request_id, prompt tokens)
    queue: List = [(i, rng.integers(4, cfg.vocab, rng.integers(2, 6)).tolist())
                   for i in range(requests)]
    state: List = [None] * B    # (req_id, tokens emitted, remaining prompt)
    lengths = np.zeros(B, np.int64)
    current = np.full(B, 1, np.int64)   # BOS
    done: List = []
    emitted = 0

    def refill():
        for b in range(B):
            if state[b] is None and queue:
                rid, prompt = queue.pop(0)
                state[b] = [rid, [], list(prompt)]
                lengths[b] = 0
                current[b] = 1

    t0 = time.time()
    steps = 0
    refill()
    while any(st is not None for st in state):
        toks = torch.as_tensor(current.reshape(B, 1), dtype=torch.int32,
                               device=dev)
        lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        cache, logits = decode_step(params, cfg, cache, toks, lens)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        steps += 1
        for b in range(B):
            if state[b] is None:
                continue
            rid, out, prompt = state[b]
            lengths[b] += 1
            if prompt:                       # still consuming the prompt
                current[b] = prompt.pop(0)
            else:
                out.append(int(nxt[b]))
                emitted += 1
                current[b] = int(nxt[b])
                if len(out) >= max_new or lengths[b] >= max_len - 1:
                    done.append((rid, out))
                    state[b] = None
        refill()
    dt = time.time() - t0
    print(f"served {len(done)} requests, {steps} decode steps in {dt:.1f}s "
          f"({steps/max(dt,1e-9):.1f} steps/s, batch={B})", flush=True)
    for rid, out in sorted(done)[:4]:
        print(f"  req {rid}: {out[:10]}", flush=True)
    return {"done": sorted(done), "steps": steps, "seconds": dt,
            "steps_per_s": steps / max(dt, 1e-9),
            "tokens_per_s": emitted / max(dt, 1e-9)}


def build_sampler(workload: str, scale: float, seed: int = 0, device=None,
                  round_batch: int = 8192, plan: str = "static",
                  shards: int = 0, backend: str = "torch"):
    """Workload → histogram warm-up → cover → ``SetUnionSampler`` on
    ``backend`` (on a mesh of ``shards`` ranks when ``shards > 0``).

    Returns ``(sampler, workload, estimates, host_build_seconds)``."""
    from ..core.framework import estimate_union, warmup
    from ..core.union_sampler import SetUnionSampler
    from ..data.workloads import WORKLOADS

    mesh = None
    if shards:              # first: a missing process group fails fast
        from ..core.sharding import make_sampler_mesh
        mesh = make_sampler_mesh(world=shards, device=device)
    t0 = time.perf_counter()
    wl = WORKLOADS[workload](scale=scale, seed=seed)
    wr = warmup(wl.cat, wl.joins, method="histogram")
    est = estimate_union(wr.oracle)
    sampler = SetUnionSampler(wl.cat, wl.joins, est.cover, seed=seed,
                              backend=backend, device=device,
                              round_batch=round_batch, plan=plan, mesh=mesh)
    return sampler, wl, est, time.perf_counter() - t0


def serve(sampler, requests: int, samples: int, batch: int,
          prefetch: int = 2, linger: float = 0.0) -> Dict[str, object]:
    """One warm-up request through a service of its own, then ``requests``
    timed requests of ``samples`` through a fresh :class:`SampleService`;
    returns the summary numbers (with the per-piece home counts of the timed
    requests).

    The clock starts before the timed service starts, so its queue is empty
    and every sample served in the window was made in it: the rate is
    samples delivered over the wall time from a cold queue to the last
    response.

    On a mesh of more than one rank the requests go straight to
    ``sampler.sample``: a prefetching producer thread stops after a number
    of rounds that depends on its rank's timing, and every rank must issue
    the same collectives.  ``linger`` keeps the timed service up that many
    seconds after the requests (for external scrapers of ``/metrics``)."""
    from ..serve import SampleService

    engine = sampler.engine         # None: the host engine's loops

    def service():
        if getattr(engine, "world", 1) > 1:
            return contextlib.nullcontext(sampler.sample)
        return SampleService(sampler, batch=batch, prefetch=prefetch)

    with service() as svc:
        getattr(svc, "request", svc)(samples)
    t0 = time.perf_counter()
    with service() as svc:
        request = getattr(svc, "request", svc)
        served = 0
        homes = np.zeros(len(sampler.order), np.int64)
        for _ in range(requests):
            ss = request(samples)
            served += len(ss)
            homes += np.bincount(ss.home, minlength=homes.shape[0])
        dt = time.perf_counter() - t0
        if linger > 0:
            print(f"lingering {linger:.0f}s for scrapes...", flush=True)
            time.sleep(linger)
    st = sampler.stats
    return {
        "requests": requests, "samples": served, "seconds": dt,
        "samples_per_s": served / max(dt, 1e-9), "psi": st.psi(),
        "candidate_draws": st.candidate_draws,
        "cover_rejects": st.cover_rejects,
        "residual_rejects": st.residual_rejects,
        "pred_rejects": st.pred_rejects,
        "dropped_slots": st.dropped_slots,
        "home_counts": homes.tolist(),
        "host_syncs": getattr(engine, "host_syncs", 0),
        "rounds_total": getattr(engine, "total_rounds", 0),
        "fused_rounds": getattr(engine, "fused_rounds", None),
    }


def main(argv: Optional[list] = None) -> Dict[str, object]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("lm", "samples"), default="lm")
    ap.add_argument("--arch", default="minitron-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=64)
    # samples mode
    ap.add_argument("--workload", default="UQ1",
                    choices=("UQ1", "UQ2", "UQ3", "UQ4"))
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--samples", type=int, default=4096)
    ap.add_argument("--round-batch", type=int, default=8192)
    ap.add_argument("--backend", choices=("torch", "numpy"), default="torch",
                    help="'torch': the device engine (the card unless "
                         "--device cpu); 'numpy': the host engine")
    ap.add_argument("--plan", choices=("static", "adaptive"),
                    default="static",
                    help="round planner: 'adaptive' budgets candidates by "
                         "acceptance EMAs carried on the device")
    ap.add_argument("--shards", type=int, default=0,
                    help="ranks of the sharded engine (0 = unsharded; "
                         "N > 1 under torchrun)")
    ap.add_argument("--prefetch", type=int, default=2,
                    help="prefetched sample batches in the serve queue")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve /metrics + /healthz on this port "
                         "(0 = ephemeral, URL printed at startup)")
    ap.add_argument("--linger", type=float, default=0.0,
                    help="keep the service + /metrics up this many seconds "
                         "after the request loop (for external scrapers)")
    args = ap.parse_args(argv)
    if args.mode == "lm":
        from ..configs import get_config, get_smoke_config
        from ..device import resolve_device
        from ..models.transformer import init_params
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(
            args.arch)
        dev = resolve_device(args.device)
        params = init_params(cfg, seed=args.seed, device=dev)
        return serve_lm(cfg, params, slots=args.slots,
                        requests=args.requests, max_new=args.max_new,
                        max_len=args.max_len, seed=args.seed, device=dev)
    rank = 0
    if args.shards > 1:
        rank = _init_ranks(args.device)
    sampler, _, _, build_s = build_sampler(args.workload, args.scale,
                                           args.seed, args.device,
                                           args.round_batch, args.plan,
                                           args.shards, args.backend)
    sampler.sample(256)                     # warm-up call
    from .. import obs
    metrics = None
    if args.metrics_port is not None and rank == 0:
        metrics = obs.MetricsServer(port=args.metrics_port).start()
        print(f"metrics: {metrics.url}/metrics  (health: "
              f"{metrics.url}/healthz)", flush=True)
    try:
        out = serve(sampler, args.requests, args.samples, args.round_batch,
                    args.prefetch, linger=args.linger)
    finally:
        if metrics is not None:
            metrics.stop()
    out["build_s"] = build_s
    out["shards"] = args.shards
    if rank == 0:
        print(f"served {args.requests} requests x {args.samples} samples "
              f"({out['samples']} total) in {out['seconds']:.3f}s — "
              f"{out['samples_per_s']:,.0f} samples/s "
              f"[backend={args.backend}, device={sampler.device or 'host'}, "
              f"workload={args.workload}, "
              f"plan={args.plan}; psi={out['psi']:.3f}, "
              f"draws={out['candidate_draws']}, "
              f"rejects={out['cover_rejects']}, "
              f"pred_rejects={out['pred_rejects']}, "
              f"shards={args.shards}, rounds={out['rounds_total']}, "
              f"host_syncs={out['host_syncs']}, "
              f"fused_rounds={out['fused_rounds']}, build={build_s:.1f}s]",
              flush=True)
        hist = obs.get_registry().get("repro_serve_request_seconds")
        if obs.enabled() and hist is not None and hist.quantile(0.5) > 0:
            print(f"request latency: p50={hist.quantile(0.5)*1e3:.2f}ms "
                  f"p99={hist.quantile(0.99)*1e3:.2f}ms", flush=True)
    return out


def _init_ranks(device) -> int:
    """Join the process group that torchrun describes (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``/``MASTER_PORT`` in the environment) and return
    this rank.  Without a launcher's environment the mesh refuses
    ``--shards N > 1``."""
    import datetime
    import os

    import torch.distributed as dist
    if not dist.is_initialized() and "MASTER_ADDR" in os.environ:
        dist.init_process_group(
            "gloo" if device == "cpu" else "nccl",
            timeout=datetime.timedelta(seconds=600))
    return dist.get_rank() if dist.is_initialized() else 0


if __name__ == "__main__":
    main()
