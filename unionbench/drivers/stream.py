"""``stream``: closed-loop clients of ``SampleService.request`` over
``SetUnionSampler(..., backend="torch")``.

Each client sends its next request as soon as the last one returns (after
``think_ms``).  Request sizes follow the mix's law; every seed gets the
same set of sizes (a fixed grid over the law), each client in an order
drawn from the seed.  A seeded sample of ``check_requests`` requests keeps
its rows for the comparison."""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np

from unionbench import program, sizes
from unionbench.harness import Record, Reservoir, Window


def setup(run) -> None:
    cfg, st = run.config, run.state
    with run.spans.span("build.catalog_s"):
        cat, joins = program.specs(run.union)
    with run.spans.span("build.warmup_s"):
        cov = program.cover(cfg, cat, joins, run.seed, run.device)
    with run.spans.span("build.catalog_s"):
        sampler = program.set_union_sampler(cfg, cat, joins, cov, run.seed,
                                            run.device)
    engine = program.TimedEngine(sampler, run.label)
    from repro_torch.serve import SampleService
    svc = SampleService(engine, batch=cfg["service"]["batch"],
                        prefetch=cfg["service"]["prefetch"]).start()
    st.update(sampler=sampler, engine=engine, service=svc,
              piece_batches=list(sampler.engine.piece_batches),
              held=threading.Event(), in_flight=[0], lock=threading.Lock())
    with run.spans.span("warm.request_s"):
        svc.request(int(sizes.grid(run.traffic).max()))


def counters(run) -> dict:
    st = run.state
    s, eng = st["sampler"], st["sampler"].engine
    out = program.stat_counters(s.stats)
    busy, clock = st["engine"].busy()
    out.update(host_syncs=eng.host_syncs, total_rounds=eng.total_rounds,
               engine_busy_s=busy, engine_clock_s=clock,
               capture_s=float(sum(eng.capture_seconds.values())))
    return out


@contextlib.contextmanager
def quiesce(run, timeout: float = 10.0):
    """Clients held back, their requests returned, and the producer
    parked on a full queue outside the engine."""
    st = run.state
    with st["lock"]:
        st["held"].set()
    try:
        end = time.perf_counter() + timeout
        while time.perf_counter() < end and not (
                st["in_flight"][0] == 0 and st["service"]._queue.full()
                and st["engine"].idle()):
            time.sleep(0.001)
        yield
    finally:
        st["held"].clear()


def window(run, t_end: float) -> Window:
    tr = run.traffic
    st = run.state
    svc = st["service"]
    grid = sizes.grid(tr)
    think = tr.get("think_ms", 0) / 1e3
    keep = Reservoir(tr["check_requests"], run.seed)
    per_client = [[] for _ in range(tr["clients"])]
    timeout = tr.get("timeout_s", 60.0)

    def client(c: int) -> None:
        order = np.random.default_rng([run.seed, c]).permutation(grid)
        recs, i = per_client[c], 0
        while True:
            while True:                     # wait while quiesced
                with st["lock"]:
                    if not st["held"].is_set():
                        st["in_flight"][0] += 1
                        break
                time.sleep(0.001)
            t0 = time.perf_counter()
            try:
                if t0 >= t_end:
                    return
                n = int(order[i % order.size])
                i += 1
                try:
                    with run.label("client.request"):
                        ss = svc.request(n, timeout=timeout)
                except Exception as e:      # a failed request delivers nothing
                    recs.append(Record(t0, time.perf_counter(), n, 0, True))
                    st.setdefault("errors", []).append(repr(e))
                    continue
            finally:
                with st["lock"]:
                    st["in_flight"][0] -= 1
            recs.append(Record(t0, time.perf_counter(), n, len(ss), False))
            keep.offer(ss.rows, ss.home)
            if think:
                time.sleep(think)

    threads = [threading.Thread(target=client, args=(c,), name=f"client-{c}")
               for c in range(tr["clients"])]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(t_end - time.perf_counter(), 0) + timeout + 60)
    if any(t.is_alive() for t in threads):
        raise RuntimeError("a client did not finish within a minute of the "
                           "window's close")
    rows, home = keep.take(run.state["engine"].attrs)
    return Window([r for recs in per_client for r in recs], rows, home)


def close(run) -> None:
    """Stop the service and wait for its producer to end: it may be inside
    an engine call longer than ``stop`` waits, and a thread left running
    into the interpreter's exit can abort the process."""
    st = run.state
    producers = [t for t in threading.enumerate()
                 if t.name.startswith("sample-producer")]
    st["service"].stop()
    for t in producers:
        t.join()
    for k in ("service", "engine", "sampler"):
        st.pop(k, None)
