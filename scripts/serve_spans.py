#!/usr/bin/env python3
"""Run a benchmark cell with the program's host spans on, and say where an
engine call and a request spend their time.

    python3 scripts/serve_spans.py --workload uq1-sf1.stream --seeds 7 8 \\
        --spans on,off,off,on --seconds 20 --trace 0 --out chiprun_out/spans

From the root of a checkout, on the card.  For each seed, and for each
entry of ``--spans`` in turn, one run of ``unionbench``'s harness in this
process: the cell's own configuration, traffic and limits, its set-up, its
window and its comparison.  ``on`` switches the spans on
(``obs.set_tracing(True)``) before the program is built; ``off`` runs the
program as the benchmark does.  While a run lasts, the stream driver's
counter snapshot gains ``span.<name>.s``, ``span.<name>.cpu_s`` and
``span.<name>.n`` from ``obs.span_totals()`` and ``graph_device_s`` from
the engine's ``graph_device_seconds``, so their deltas cover the window's
counted stretches (the traced slice and its switches left out).  From them
:func:`layer_metrics` derives six per-layer quantities:

* ``serve.queue_wait_share`` (%): Σ``serve.queue_wait`` / Σ``serve.request``;
* ``serve.producer_park_share`` (%): Σ``serve.put_wait`` / counted seconds;
* ``serve.assemble_ms_per_request``: Σ``serve.assemble`` per request;
* ``loop.host_ms_per_ksample``: Σ``loop.dispatch`` + Σ``loop.result`` −
  Σ``loop.chunk_sync`` − Σ``loop.fetch``, per 1,000 samples emitted;
* ``loop.graph_busy_share`` (%): Δ``graph_device_s`` / counted seconds (on
  the card only);
* ``host.offcpu_share`` (%): Σ(wall − thread CPU) / Σ wall over
  ``serve.assemble``, ``loop.replay``, ``loop.pack``, ``loop.fold`` and
  ``loop.fingerprint``.

Each run prints one JSON line (the result's metrics, ``correct``, the
device, the six quantities, every span's seconds, thread-CPU seconds and
count over the counted stretches, with ``--trace 1`` the traced slice's
breakdown, whose idle gaps the spans now name, and a time series: each
second of the run, from the warm traffic to the window's end, the spans'
seconds, the engine calls and requests closed, the process's CPU seconds
and the host's load average); ``--out`` also writes them to
``<out>/<cell>.jsonl``.  Without a CUDA card it exits with 2.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import subprocess
import sys
import threading
import time
from typing import Dict, Optional

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "unionbench"
HOST_SPANS = ("serve.assemble", "loop.replay", "loop.pack", "loop.fold",
              "loop.fingerprint")
SERIES_SPANS = ("serve.request", "serve.queue_wait", "serve.assemble",
                "serve.put_wait", "loop.dispatch", "loop.replay",
                "loop.finish", "loop.chunk_sync", "loop.pack", "loop.result",
                "loop.fingerprint")


def span_counters() -> Dict[str, float]:
    """The spans' totals as flat counters."""
    from repro_torch import obs
    return {f"span.{name}.{k}": float(v)
            for name, t in obs.span_totals().items() for k, v in t.items()}


def layer_metrics(run) -> Dict[str, float]:
    """The six per-layer quantities over ``run``'s counted stretches; one
    with nothing to read is left out (all of them while the spans are
    off)."""
    def d(name: str, field: str = "s") -> float:
        return run.delta(f"span.{name}.{field}")

    clock = run.delta("clock_s")
    if clock <= 0 or d("serve.request", "n") <= 0:
        return {}
    out = {"serve.queue_wait_share":
           100.0 * d("serve.queue_wait") / d("serve.request"),
           "serve.producer_park_share": 100.0 * d("serve.put_wait") / clock,
           "serve.assemble_ms_per_request":
           1e3 * d("serve.assemble") / d("serve.request", "n")}
    emitted = run.delta("samples_emitted")
    if emitted > 0:
        host = (d("loop.dispatch") + d("loop.result") - d("loop.chunk_sync")
                - d("loop.fetch"))
        out["loop.host_ms_per_ksample"] = 1e3 * host / (emitted / 1e3)
    if getattr(run.device, "type", str(run.device)) == "cuda":
        out["loop.graph_busy_share"] = 100.0 * run.delta("graph_device_s") / clock
    wall = sum(d(n) for n in HOST_SPANS)
    if wall > 0:
        cpu = sum(d(n, "cpu_s") for n in HOST_SPANS)
        out["host.offcpu_share"] = 100.0 * (wall - cpu) / wall
    return out


def span_window(run) -> Dict[str, Dict[str, float]]:
    """Every span's seconds, thread-CPU seconds and count over the counted
    stretches, and its seconds as a share (%) of them."""
    clock = run.delta("clock_s")
    names = sorted({k[5:].rsplit(".", 1)[0] for k in run.after
                    if k.startswith("span.")})
    out = {}
    for name in names:
        n = run.delta(f"span.{name}.n")
        if n <= 0:
            continue
        s = run.delta(f"span.{name}.s")
        out[name] = {"s": s, "cpu_s": run.delta(f"span.{name}.cpu_s"), "n": n,
                     "share": 100.0 * s / clock if clock > 0 else None}
    return out


@contextlib.contextmanager
def spans_in_counters(box: dict):
    """The harness's drivers, loaded while this lasts, add the span and
    CUDA-event counters to their snapshots and leave the finished run (and
    its six quantities) in ``box`` at their ``close``."""
    from unionbench import harness
    load = harness.driver_module

    def driver_module(kind, pkg=harness.PKG):
        mod = load(kind, pkg)
        counters, close = mod.counters, mod.close

        def with_spans(run):
            out = counters(run)
            out.update(span_counters())
            eng = run.state["sampler"].engine
            out["graph_device_s"] = float(getattr(eng, "graph_device_seconds",
                                                  0.0))
            return out

        def closing(run):
            box.update(run=run, layer=layer_metrics(run),
                       spans=span_window(run))
            close(run)

        mod.counters, mod.close = with_spans, closing
        return mod

    harness.driver_module = driver_module
    try:
        yield box
    finally:
        harness.driver_module = load


class Series:
    """Span totals, the process's CPU seconds and the load average, read
    every ``every`` seconds on a thread of its own while it lasts."""

    def __init__(self, every: float = 1.0):
        self.every = every
        self.reads = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._read, name="span-series",
                                        daemon=True)

    def _read(self) -> None:
        from repro_torch import obs
        while True:
            self.reads.append((time.perf_counter(), time.process_time(),
                               os.getloadavg()[0], obs.span_totals()))
            if self._stop.wait(self.every):
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)
        return False

    def per_second(self, t0: float):
        """Per read interval: its end on the clock of the window's start
        ``t0``, and what changed in it."""
        out = []
        for (ta, pa, _, a), (tb, pb, load, b) in zip(self.reads,
                                                     self.reads[1:]):
            zero = {"s": 0.0, "n": 0}
            row = {"t": round(tb - t0, 3), "cpu": round((pb - pa) / (tb - ta), 3),
                   "load": load,
                   "calls": b.get("loop.result", zero)["n"]
                   - a.get("loop.result", zero)["n"],
                   "requests": b.get("serve.request", zero)["n"]
                   - a.get("serve.request", zero)["n"]}
            for name in SERIES_SPANS:
                row[name] = round(b.get(name, zero)["s"]
                                  - a.get(name, zero)["s"], 4)
            out.append(row)
        return out


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool,
             spans: bool, device, pkg: Optional[pathlib.Path] = None
             ) -> Dict[str, object]:
    """One run of ``cell`` with the spans on or off; returns a summary."""
    from repro_torch import obs
    from unionbench import harness
    box: dict = {}
    obs.set_tracing(spans)
    try:
        with spans_in_counters(box), Series() as series:
            res = harness.execute(bench, cell, seed, seconds, trace, device,
                                  pkg=pkg or harness.PKG)
    finally:
        obs.set_tracing(None)
    info = res.get("_info", {})
    run = box.get("run")
    return {"cell": cell, "seed": seed, "spans": spans, "trace": trace,
            "correct": res["correct"], "failed": res["failed"],
            "device": res["device"], "metrics": {
                k: v["value"] for k, v in res["metrics"].items()},
            "layer": box.get("layer", {}), "span_window": box.get("spans", {}),
            "engine_busy_s": info.get("window", {}).get("engine_busy_s"),
            "samples_each_second": info.get("samples_each_second"),
            "breakdown": res.get("breakdown"),
            "series": (series.per_second(run.t_window)
                       if spans and run is not None else None)}


def _card() -> Optional[str]:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--spans", default="on",
                    help="comma-separated on/off, run in turn for each seed")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    order = [s.strip() for s in args.spans.split(",")]
    if not set(order) <= {"on", "off"}:
        ap.error("--spans takes on and off, comma-separated")

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ.setdefault(var, str(CACHE / sub))
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    from unionbench import harness
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = harness.spec(ROOT)
    device = torch.device("cuda", 0)
    card = _card()
    out = None
    if args.out:
        pathlib.Path(args.out).mkdir(parents=True, exist_ok=True)
        out = open(pathlib.Path(args.out) / f"{args.workload}.jsonl", "a")
    try:
        for seed in args.seeds:
            for spans in order:
                t0 = time.perf_counter()
                line = run_cell(bench, args.workload, seed, args.seconds,
                                bool(args.trace), spans == "on", device)
                line.update(card=card, run_s=time.perf_counter() - t0)
                text = json.dumps(line, default=str)
                print(text, flush=True)
                if out is not None:
                    out.write(text + "\n")
                    out.flush()
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
