"""A profiled slice of the window: device intervals from ``torch.profiler``
(CUPTI) and what the host was doing in the device's idle gaps.

Only a short slice is traced: a round of the stream cells launches some
thousands of kernels, and the trace of a whole window would be large and
slow to read.  :func:`summarise` reads the raw kineto events (no
``key_averages`` tree) and returns the union of device intervals, the
device time and count per operation name, and the longest idle gaps, each
named by the innermost host range or operator that covers its middle."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import numpy as np

FAMILIES = (                 # the family grouping of the device ops
    ("probe kernels", lambda s: "probe" in s and "kernel" in s),
    ("memcpy/memset", lambda s: "memcpy" in s or "memset" in s),
    ("searchsorted", lambda s: "searchsorted" in s),
    ("index/gather", lambda s: "index" in s or "gather" in s),
    ("scatter", lambda s: "scatter" in s),
    ("scan/reduce", lambda s: "scan" in s or "reduce" in s or "cumsum" in s),
    ("sort/unique", lambda s: "sort" in s or "unique" in s),
    ("elementwise", lambda s: "elementwise" in s),
)
NAME_CHARS = 160


def family(name: str) -> str:
    low = name.lower()
    for fam, hit in FAMILIES:
        if hit(low):
            return fam
    return "other"


def label(tracing: bool):
    """A context-manager factory: a profiler range when tracing, else
    nothing."""
    if not tracing:
        return lambda name: contextlib.nullcontext()
    import torch
    return torch.profiler.record_function


def _profile():
    """A CPU + CUDA profiler session that records the host ranges of every
    thread where this PyTorch can."""
    from torch.profiler import ProfilerActivity, profile
    kw = {}
    try:
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   **kw)


class Slice:
    """Starts and stops one profiler session; ``seconds`` is its length on
    the host clock.  Made before the program is built: CUPTI initialises at
    the first session (some seconds), and it records the kernels of a CUDA
    graph only where it was initialised before the graph was instantiated,
    so a short session runs here, in set-up."""

    def __init__(self):
        import torch
        t = time.perf_counter()
        warm = _profile()
        warm.start()
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        warm.stop()
        self.init_s = time.perf_counter() - t
        self.prof = _profile()
        self.seconds = 0.0
        self.start_s = 0.0          # how long starting the profiler took
        self._t0 = 0.0

    def start(self) -> None:
        t = time.perf_counter()
        self.prof.start()
        self._t0 = time.perf_counter()
        self.start_s = self._t0 - t

    def mark(self, name: str) -> None:
        """A zero-length host range that bounds the traced slice: the
        slice is read between ``slice.begin`` (clients released after the
        profiler's start) and ``slice.end`` (before they are held for its
        stop), so the held stretches count as no idle time."""
        import torch
        with torch.profiler.record_function(name):
            pass

    def stop(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self._t0
        self.prof.stop()


def _events(prof) -> Tuple[List, List]:
    """(device events, host events) as (name, start_ns, end_ns).  A host
    range's mirror on the device timeline (a user annotation, named as the
    range) is no device operation and is left out."""
    import torch
    dev, host = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "start_ns"):
            s, d = e.start_ns(), e.duration_ns()
        else:
            s, d = e.start_us() * 1000, e.duration_us() * 1000
        (dev if e.device_type() == cuda else host).append((e.name(), s, s + d))
    ranges = {name for name, _, _ in host}
    return [e for e in dev if e[0] not in ranges], host


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged (start, end) intervals, sorted."""
    if iv.size == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
    starts = iv[new, 0]
    last = np.concatenate([np.flatnonzero(new)[1:] - 1, [iv.shape[0] - 1]])
    return np.stack([starts, ends[last]], axis=1)


def _bounds(host: List) -> Tuple[int, int]:
    """The slice's (begin, end) on the trace's clock, from its marks."""
    at = {name: (s, e) for name, s, e in host
          if name in ("slice.begin", "slice.end")}
    if len(at) < 2:
        raise RuntimeError("the trace holds no slice.begin/slice.end marks")
    return at["slice.begin"][1], at["slice.end"][0]


def summarise(sl: Slice, top: int = 10) -> Dict[str, object]:
    dev, host = _events(sl.prof)
    begin, end = _bounds(host)
    # device work clipped to the slice between its marks
    dev = [(n, max(s, begin), min(e, end)) for n, s, e in dev
           if e > begin and s < end]
    out: Dict[str, object] = {"window_s": (end - begin) / 1e9,
                              "session_s": sl.seconds,
                              "device_events": len(dev),
                              "start_s": sl.start_s, "init_s": sl.init_s,
                              "host_events": len(host)}
    if not dev:
        out.update(busy_s=0.0, by_name={}, by_family={}, idle_gaps=[])
        return out
    iv = np.asarray([(s, e) for _, s, e in dev], dtype=np.int64)
    merged = _union(iv)
    out["busy_s"] = float((merged[:, 1] - merged[:, 0]).sum()) / 1e9
    by_name: Dict[str, List[float]] = {}
    for name, s, e in dev:
        v = by_name.setdefault(name, [0.0, 0])
        v[0] += (e - s) / 1e9
        v[1] += 1
    out["by_name"] = by_name
    fams: Dict[str, float] = {}
    for name, (sec, _) in by_name.items():
        f = family(name)
        fams[f] = fams.get(f, 0.0) + sec
    out["by_family"] = fams
    gaps = np.stack([merged[:-1, 1], merged[1:, 0]], axis=1)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    order = np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")[:top]
    hs = np.asarray([s for _, s, _ in host], dtype=np.int64)
    he = np.asarray([e for _, _, e in host], dtype=np.int64)
    named = []
    for g in order:
        a, b = gaps[g]
        mid = (a + b) // 2
        cover = np.flatnonzero((hs <= mid) & (he >= mid)) if hs.size else []
        if len(cover):
            inner = cover[np.argmax(hs[cover])]
            what = host[inner][0]
        else:
            what = "no host range"
        named.append([what[:NAME_CHARS], float(b - a) / 1e9])
    out["idle_gaps"] = named
    return out


def breakdown(summary: Dict[str, object], top: int = 10) -> Dict[str, list]:
    """The result line's ``breakdown``: the device operations that took
    most time (family and profiler name) and the longest idle gaps."""
    by_name = summary.get("by_name", {})
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"device_ops": [[f"[{family(n)}] {n}"[:NAME_CHARS], v[0]]
                           for n, v in ops],
            "idle_gaps": list(summary.get("idle_gaps", []))[:top]}
