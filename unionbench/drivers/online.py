"""``online``: Algorithm 2 (``OnlineUnionSampler``), grown by one client
that asks for ``step`` more rows at a time (``sample(k + step)``, closed
loop), with no parameters computed beforehand.  The membership oracle's
``contains`` is timed.  Every request's new rows are checked."""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np

from unionbench import program
from unionbench.harness import Record, Window


def setup(run) -> None:
    cfg, st = run.config, run.state
    with run.spans.span("build.catalog_s"):
        cat, joins = program.specs(run.union)
    with run.spans.span("online.init_s"):
        s = program.online_sampler(cfg, cat, joins, run.seed, run.device)
    s.prober.contains = program.TimedCall(s.prober.contains, run.label,
                                          "online.contains")
    st.update(sampler=s, have=0, held=threading.Event(),
              busy=threading.Event(), lock=threading.Lock())
    with run.spans.span("warm.request_s"):
        s.sample(int(run.traffic["step"]))
        st["have"] = int(run.traffic["step"])


def counters(run) -> dict:
    s = run.state["sampler"]
    out = program.stat_counters(s.stats)
    out.update(contains_s=s.prober.contains.seconds,
               contains_calls=s.prober.contains.calls,
               accepted=len(s._accepted), refreshes=s.refresh_count)
    return out


@contextlib.contextmanager
def quiesce(run):
    """The one client runs in the window's thread: hold it before its next
    request and wait for the one in flight."""
    st = run.state
    with st["lock"]:
        st["held"].set()
    try:
        while st["busy"].is_set():
            time.sleep(0.001)
        yield
    finally:
        st["held"].clear()


def window(run, t_end: float) -> Window:
    s, st = run.state["sampler"], run.state
    step = int(run.traffic["step"])
    think = run.traffic.get("think_ms", 0) / 1e3
    recs, parts = [], []
    while True:
        while True:                         # wait while quiesced
            with st["lock"]:
                if not st["held"].is_set():
                    st["busy"].set()
                    break
            time.sleep(0.001)
        t0 = time.perf_counter()
        if t0 >= t_end:
            st["busy"].clear()
            break
        k = st["have"]
        try:
            with run.label("client.request"):
                ss = s.sample(k + step)
        except Exception as e:
            recs.append(Record(t0, time.perf_counter(), step, 0, True))
            st.setdefault("errors", []).append(repr(e))
            continue
        finally:
            st["busy"].clear()
        got = len(ss) - k
        recs.append(Record(t0, time.perf_counter(), step, got, False))
        parts.append(({a: c[k:] for a, c in ss.rows.items()}, ss.home[k:]))
        st["have"] = len(ss)
        if think:
            time.sleep(think)
    attrs = list(s.attrs)
    rows = {a: np.concatenate([p[0][a] for p in parts]) if parts
            else np.zeros(0, np.int64) for a in attrs}
    home = (np.concatenate([p[1] for p in parts]) if parts
            else np.zeros(0, np.int64))
    return Window(recs, rows, home)


def close(run) -> None:
    run.state.pop("sampler", None)
