"""One run of one cell: set-up, the measured window, the traced slice, the
comparison with the reference, and the result line.

Everything that belongs to one configuration, traffic mix, metric or
cell's limits sits in a file of its own, found by the name that
``BENCHMARK.json`` gives:

* ``unionbench/configs/<config>.json`` — the deployment: its ``workload``
  names the builder ``unionbench/inputs/<workload>.py`` and its
  ``reference`` the module ``unionbench/reference/<reference>.py`` whose
  ``reference(union, precision)`` the comparison reads;
* ``unionbench/traffic/<mix>.json`` — the mix; its ``driver`` names
  ``unionbench/drivers/<driver>.py``;
* ``unionbench/metrics/<metric>.py`` — one reader per metric, with a
  ``read(run)`` that returns a number or ``None`` (nothing to read);
* ``unionbench/checks/<cell>.json`` — each number compared and its limit.

A driver module has ``setup(run)`` (build the program and warm every
shape the mix uses), ``window(run, t_end)`` (drive the mix until
``t_end``; returns the per-request records and the checked rows),
``counters(run)`` (a snapshot of the program's counters), ``quiesce(run)``
(a context in which no client request and no engine call is in flight)
and ``close(run)`` (stop and free the program).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import pathlib
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from unionbench import inputs, profiling, program

PKG = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
PROFILE_SECONDS = 1.0       # the traced slice's length, at most half the window
PROFILE_AT = 0.25           # ... starting this share into the window


class Spans:
    """Seconds per named host span (summed over repeats)."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)


@dataclasses.dataclass
class Record:
    issued: float
    done: float
    asked: int
    got: int
    failed: bool


@dataclasses.dataclass
class Window:
    records: List[Record]
    rows: Dict[str, np.ndarray]      # checked rows (concatenated)
    home: np.ndarray


class Reservoir:
    """A seeded uniform sample of ``k`` requests' rows (Algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = np.random.default_rng([int(seed), 0x5EED])
        self.items: List = []
        self.seen = 0
        self.lock = threading.Lock()

    def offer(self, rows, home) -> None:
        with self.lock:
            self.seen += 1
            if len(self.items) < self.k:
                self.items.append((rows, home))
                return
            i = int(self.rng.integers(0, self.seen))
            if i < self.k:
                self.items[i] = (rows, home)

    def take(self, attrs):
        if not self.items:
            return ({a: np.zeros(0, np.int64) for a in attrs},
                    np.zeros(0, np.int64))
        rows = {a: np.concatenate([np.asarray(r[a]) for r, _ in self.items])
                for a in attrs}
        home = np.concatenate([np.asarray(h) for _, h in self.items])
        return rows, home


@dataclasses.dataclass
class Run:
    """Everything a driver and a metric reader see of one run."""
    cell: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    union: object = None
    spans: Spans = dataclasses.field(default_factory=Spans)
    label: Callable = None
    state: dict = dataclasses.field(default_factory=dict)
    setup_s: float = 0.0
    window: Optional[Window] = None
    t_window: float = 0.0
    before: dict = dataclasses.field(default_factory=dict)
    after: dict = dataclasses.field(default_factory=dict)
    # counter snapshots that bound the stretches of the window the counters
    # cover: the whole window, or, when tracing, the window less the
    # profiler's switches (clients held) and the slice between them
    marks: List[dict] = dataclasses.field(default_factory=list)
    profile: Optional[dict] = None
    peak_bytes: int = 0

    def counted(self, records: List[Record]) -> List[Record]:
        """The records that lie inside the window's counted stretches."""
        spans = [(a["clock_s"], b["clock_s"])
                 for a, b in zip(self.marks[::2], self.marks[1::2])]
        if not spans:
            return list(records)
        return [r for r in records
                if any(a <= r.issued and r.done <= b for a, b in spans)]

    def delta(self, key: str) -> float:
        """A counter's change over the window's counted stretches."""
        marks = self.marks or [self.before, self.after]
        return sum(float(b.get(key, 0.0)) - float(a.get(key, 0.0))
                   for a, b in zip(marks[::2], marks[1::2]))


def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: pathlib.Path) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def _module(path: pathlib.Path, name: str):
    s = importlib.util.spec_from_file_location(name, path)
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m


def _ident(name: str) -> str:
    return name.replace(".", "_").replace("-", "_")


def reader(metric: str, pkg: pathlib.Path = PKG):
    return _module(pkg / "metrics" / f"{metric}.py",
                   "unionbench_metric_" + _ident(metric))


def driver_module(kind: str, pkg: pathlib.Path = PKG):
    return _module(pkg / "drivers" / f"{kind}.py",
                   "unionbench_driver_" + _ident(kind))


def reference_entry(config: dict):
    """The entry ``reference(union, precision="f64")`` of the module under
    ``unionbench/reference/`` that the configuration names."""
    return importlib.import_module(
        f"unionbench.reference.{config['reference']}").reference


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def forbidden_modules(names=None) -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, the
    name compared whole (``repro_torch`` is not ``repro``)."""
    names = list(sys.modules) if names is None else list(names)
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def execute(bench: dict, cell: str, seed: int, seconds: float, trace: bool,
            device, pkg: pathlib.Path = PKG, t_start: Optional[float] = None
            ) -> Dict[str, object]:
    """One run; returns the result object (without printing it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    entry = cell_entry(bench, cell)
    config = load_json(pkg / "configs" / f"{entry['config']}.json")
    traffic = load_json(pkg / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(pkg / "checks" / f"{cell}.json")
    driver = driver_module(traffic["driver"], pkg)
    reference = reference_entry(config)
    run = Run(cell, config, traffic, int(seed), float(seconds), bool(trace),
              device, label=profiling.label(trace))
    cuda = getattr(device, "type", str(device)) == "cuda"
    program.load_kernels(run)
    sl = profiling.Slice() if trace and cuda else None
    with run.spans.span("build.inputs_s"):
        run.union = inputs.build(config, run.seed)
    driver.setup(run)
    warm = float(traffic.get("warm_s", 0.0))
    if warm > 0:
        # the mix itself until the program runs at its steady rate; its
        # requests are neither counted nor checked
        with run.spans.span("warm.traffic_s"):
            driver.window(run, time.perf_counter() + warm)
    if cuda:
        import torch
        torch.cuda.synchronize()
    run.setup_s = time.perf_counter() - t_start

    t0 = time.perf_counter()
    t_end = t0 + run.seconds
    run.t_window = t0
    run.state["window_start_unix"] = time.time()
    snap = lambda: dict(driver.counters(run), clock_s=time.perf_counter())  # noqa: E731
    run.before = snap()
    p = min(PROFILE_SECONDS, run.seconds / 2)
    box: Dict[str, object] = {}

    def drive():
        try:
            box["window"] = driver.window(run, t_end)
        except BaseException as e:          # re-raised in the main thread
            box["error"] = e
    worker = threading.Thread(target=drive, name="window")
    worker.start()
    # the profiler starts and stops in the main thread, where CUPTI's client
    # is registered, while no CUDA call is in flight (the driver holds its
    # clients back and waits for the program to idle); counters are read at
    # the close
    if sl is not None:
        time.sleep(max(t0 + PROFILE_AT * run.seconds - time.perf_counter(), 0.0))
        run.marks += [run.before, snap()]
        with driver.quiesce(run):
            sl.start()
        sl.mark("slice.begin")
        time.sleep(p)
        sl.mark("slice.end")
        with driver.quiesce(run):
            sl.stop()
        run.marks.append(snap())
    time.sleep(max(t_end - time.perf_counter(), 0.0))
    run.after = snap()
    if run.marks:
        run.marks.append(run.after)
    worker.join()
    if "error" in box:
        raise box["error"]
    run.window = box["window"]
    if cuda:
        import torch
        torch.cuda.synchronize()
        run.peak_bytes = int(torch.cuda.max_memory_allocated())
    if sl is not None:
        t_sum = time.perf_counter()
        run.profile = profiling.summarise(sl)
        run.profile["summarise_s"] = time.perf_counter() - t_sum
        del sl
    driver.close(run)
    gc.collect()
    if cuda:
        import torch
        torch.cuda.empty_cache()

    # --- the comparison with the reference (after the program is freed)
    from unionbench.reference import judge
    ref = reference(run.union)
    recs = run.window.records
    t_judge = time.perf_counter()
    numbers, info = judge.judge(ref, [r.asked for r in recs],
                                [r.got for r in recs], run.window.rows,
                                run.window.home, list(limits))
    numbers = {k: float(v) for k, v in numbers.items()}
    correct = judge.passes(numbers, limits)
    done = np.asarray([r.done - t0 for r in recs if not r.failed])
    got = np.asarray([r.got for r in recs if not r.failed])
    per_s = np.bincount(np.clip(done, 0, None).astype(int), weights=got)
    info.update(judge_s=time.perf_counter() - t_judge, spans=run.spans.seconds,
                window={k: run.delta(k) for k in run.after},
                samples_each_second=per_s.astype(int).tolist(),
                piece_batches=run.state.get("piece_batches"),
                window_start_unix=run.state.get("window_start_unix"),
                errors=run.state.get("errors", [])[:3])
    if run.profile is not None:
        info.update({k: run.profile.get(k) for k in (
            "by_family", "device_events", "host_events", "start_s", "init_s", "session_s",
            "summarise_s")})

    # --- metrics
    metrics = {}
    group = "per_layer" if trace else "end_to_end"
    for m in bench[group]:
        if not applies(m, cell):
            continue
        v = reader(m["name"], pkg).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    failed = sum(r.failed for r in recs)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": _device_kind(device), "count": 1,
           "memory_peak_bytes": run.peak_bytes}
    result: Dict[str, object] = {
        "correct": bool(correct), "attempted": len(recs), "failed": failed,
        "metrics": metrics, "device": dev}
    if trace and run.profile is not None:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        result["breakdown"] = profiling.breakdown(run.profile)
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in numbers}
    result["_info"] = info
    return result


def _device_kind(device) -> str:
    if getattr(device, "type", str(device)) == "cuda":
        import torch
        return torch.cuda.get_device_name(device)
    return "cpu"


def emit(result: Dict[str, object], out=sys.stdout, err=sys.stderr) -> int:
    """Prints the checks on stderr (last) and the result as the last line
    of stdout; returns the exit code (3 where a forbidden module is
    loaded, and then prints no result)."""
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=err, flush=True)
        return 3
    info = result.pop("_info", {})
    print(f"details {json.dumps(info, default=str)}", file=err)
    for k, v in result["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0
