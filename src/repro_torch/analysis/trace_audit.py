"""Layer 2: trace audit of the round programs.

The counterpart of the reference's ``repro/analysis/jaxpr_audit.py``.  The
AST lint (layer 1) reasons about *source*; this layer runs the real
``TorchUnionSampler`` / ``ShardedUnionSampler`` engines on small workloads
and records what their calls and rounds issue, which source lint cannot
see:

* **Collective discipline** — the unsharded engine's whole ``sample(n)``
  issues *zero* collectives, in the device loop and in the host loop
  (counted by ``torch.distributed.tensor.debug.CommDebugMode``).
* **Sharded rounds** — one round of the sharded device loop
  (``_shard_step``) issues the collectives of the per-rank round
  (``_local_round``: the fingerprint exchange's ``all_gather`` and
  ``reduce_scatter`` at world > 1) plus exactly one banking
  ``all_gather_into_tensor`` of the count stack; one round of its host
  loop issues the same per-rank round plus one ``all_gather`` of the
  accepted matrices.  At world 1 the port skips every exchange, so both
  are empty.  World > 1 needs a process group of that many ranks (the
  tests run two gloo ranks).
* **RNG parity** — one call of the device loop (in one chunk of more
  rounds than the call needs) and of the host loop from the same seed
  leave the sampler's Philox generator at the same position (its offset
  on the card, its state on the CPU): the device loop's gated rounds are
  rewound, so both consume the same stream.

The reference's donation and ``while``-fusion checks have no counterpart:
eager PyTorch donates nothing (the loop updates its static buffers in
place) and fuses rounds by replaying a captured CUDA graph, which
:mod:`repro_torch.analysis.recompile` audits.  Everything returns
:class:`~repro_torch.analysis.findings.Finding` objects so the gate merges
them with the AST layer's output.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Sequence, Tuple

from .findings import Finding


def _finding(label: str, message: str, detail: str) -> Finding:
    return Finding(rule="trace-audit", path=f"<audit:{label}>", line=0,
                   scope=label, message=message, detail=detail)


# -- engine builders ----------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _workload(workload: str):
    from ..core.framework import estimate_union, warmup
    from ..data import workloads
    if workload == "uq1":
        wl = workloads.uq1(scale=0.02, overlap=0.4, seed=0, n_joins=2)
    elif workload == "uq4":
        wl = workloads.uq4(scale=0.04, seed=0)
    else:
        raise ValueError(f"unknown audit workload {workload!r}")
    cover = estimate_union(warmup(wl.cat, wl.joins, method="exact")
                           .oracle).cover
    return wl, cover


def build_engine(workload: str = "uq1", plan: str = "static",
                 world: int = 0, round_batch: int = 256,
                 fused_rounds: str = "device", device=None, seed: int = 11):
    """Build the real engine a tier-1 run would use, on a small workload,
    on ``device`` (``None``: the card; it raises without one unless
    ``device="cpu"``).

    ``world=0`` returns an unsharded ``TorchUnionSampler``; ``world>=1``
    builds the mesh path (``ShardedUnionSampler``) with that many ranks,
    which needs a process group of ``world`` ranks when ``world > 1``."""
    from ..core.union_sampler import SetUnionSampler
    from ..device import resolve_device

    device = resolve_device(device)
    wl, cover = _workload(workload)
    kwargs: Dict[str, Any] = {}
    if world:
        from ..core.sharding import make_sampler_mesh
        kwargs["mesh"] = make_sampler_mesh(world=world, device=device)
    sampler = SetUnionSampler(wl.cat, wl.joins, cover, seed=seed,
                              backend="torch", device=device,
                              round_batch=round_batch,
                              fused_rounds=fused_rounds, plan=plan, **kwargs)
    return sampler.engine


# -- collective logs ----------------------------------------------------------

def _collective_log():
    """A dispatch mode that lists the collective kinds it sees, in order."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from ..launch.hlo_census import _kind

    class CollectiveLog(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.kinds: List[str] = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kind = _kind(func)
            if kind is not None:
                self.kinds.append(kind)
            return func(*args, **(kwargs or {}))

    return CollectiveLog()


def collectives_of(fn, *args) -> Tuple[object, List[str]]:
    """Run ``fn(*args)``; returns (its result, the collectives it issued in
    order), held equal in number to ``CommDebugMode``'s count."""
    from torch.distributed.tensor.debug import CommDebugMode
    comm, log = CommDebugMode(), _collective_log()
    with comm, log:
        out = fn(*args)
    if comm.get_total_counts() != len(log.kinds):
        raise RuntimeError(f"trace audit: CommDebugMode counted "
                           f"{comm.get_total_counts()} collectives, the log "
                           f"{len(log.kinds)}")
    return out, log.kinds


def _same_position(a, b) -> bool:
    """Two stream marks (``PhiloxUniforms.mark``: the generator's state on
    the CPU, its offset on the card) are equal."""
    import torch
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


# -- audits -------------------------------------------------------------------

CHUNK_ROUNDS = 4

def audit_unsharded(workload: str, plan: str, label: str, n: int = 600,
                    round_batch: int = 256, device=None
                    ) -> Tuple[List[Finding], Dict[str, Any]]:
    """One ``sample(n)`` of the device loop and of the host loop from the
    same seed on ``device`` (``None``: the card): no collective in either,
    the same rounds, the same stream position after the call."""
    dev, host = (build_engine(workload, plan, round_batch=round_batch,
                              fused_rounds=mode, device=device)
                 for mode in ("device", "host"))
    # one chunk of more rounds than the call needs: the gated rounds drew
    # uniforms that the device loop must take back
    dev.chunk_rounds = CHUNK_ROUNDS
    _, dev_cols = collectives_of(dev.sample, n)
    _, host_cols = collectives_of(host.sample, n)
    findings: List[Finding] = []
    for side, cols in (("device", dev_cols), ("host", host_cols)):
        if cols:
            findings.append(_finding(
                label, f"unsharded {side} loop issues collectives",
                f"{side}:{cols}"))
    if dev.last_rounds != host.last_rounds:
        findings.append(_finding(
            label, "device and host loops ran different rounds",
            f"device={dev.last_rounds} host={host.last_rounds}"))
    same = _same_position(dev.uniforms.mark(), host.uniforms.mark())
    if not same:
        findings.append(_finding(
            label, "device and host loops leave the Philox stream at "
            "different positions", "rng:position"))
    if dev.last_wasted_rounds <= 0:
        findings.append(_finding(
            label, "the device loop gated no round, so the rewind went "
            "unchecked", f"wasted={dev.last_wasted_rounds}"))
    report = {
        "label": label, "kind": "unsharded", "plan": plan, "n": n,
        "device": str(dev.device),
        "rounds": dev.last_rounds,
        "gated_rounds": dev.last_wasted_rounds,
        "collectives": dev_cols + host_cols,
        "same_stream_position": same, "findings": len(findings),
    }
    return findings, report


def _round_collectives(eng, n: int) -> Tuple[List[str], List[str]]:
    """The collectives of one round of ``eng``'s loop on a fresh class
    ``1024`` call of ``n`` rows, and those of the per-rank round inside
    it: (round, per-rank round)."""
    eng._state = eng._init_state()
    cb = eng._call_buffers(1024)
    cb.ctr.zero_()
    cb.n.fill_(n)
    inner: List[List[str]] = []
    local = eng._local_round
    log = _collective_log()

    def logged(*a, **kw):
        start = len(log.kinds)
        out = local(*a, **kw)
        inner.append(list(log.kinds[start:]))
        return out

    from torch.distributed.tensor.debug import CommDebugMode
    eng._local_round = logged
    try:
        with CommDebugMode() as comm, log:
            eng._round_step(cb)
    finally:
        del eng._local_round
    if comm.get_total_counts() != len(log.kinds) or len(inner) != 1:
        raise RuntimeError("trace audit: the round's collectives were not "
                           "all seen")
    return log.kinds, inner[0]


def audit_sharded(world: int, label: str, plan: str = "static",
                  n: int = 1000, round_batch: int = 256, device=None
                  ) -> Tuple[List[Finding], Dict[str, Any]]:
    """One round of the sharded device loop and of its host loop at
    ``world`` ranks (this process one of them): the device round is the
    per-rank round plus one banking ``all_gather``, the host round the
    same per-rank round plus one ``all_gather`` of the matrices; at world 1
    all three are empty."""
    dev, host = (build_engine("uq1", plan, world=world,
                              round_batch=round_batch, fused_rounds=mode,
                              device=device)
                 for mode in ("device", "host"))
    dev_cols, dev_local = _round_collectives(dev, n)
    host_cols, host_local = _round_collectives(host, n)
    tail = ["all-gather"] if world > 1 else []
    findings: List[Finding] = []
    if dev_local != host_local:
        findings.append(_finding(
            label, "the device and host loops' per-rank rounds issue "
            "different collectives", f"device={dev_local} host={host_local}"))
    if dev_cols != dev_local + tail:
        findings.append(_finding(
            label, "sharded device round is not the per-rank round plus "
            "one banking all_gather", f"round={dev_cols} local={dev_local}"))
    if host_cols != host_local + tail:
        findings.append(_finding(
            label, "sharded host round is not the per-rank round plus one "
            "all_gather of the matrices",
            f"round={host_cols} local={host_local}"))
    report = {
        "label": label, "kind": "sharded", "plan": plan, "world": world,
        "device": str(dev.device),
        "collectives": dev_cols, "host_collectives": host_cols,
        "local_collectives": dev_local, "findings": len(findings),
    }
    return findings, report


# default audit matrix: both plan regimes on the acyclic 2-join union, the
# cyclic union, and the world-1 mesh path (world > 1 runs in the tests'
# gloo ranks)
DEFAULT_AUDITS: Tuple[Tuple[str, Dict[str, Any]], ...] = (
    ("uq1-static", dict(workload="uq1", plan="static")),
    ("uq1-adaptive", dict(workload="uq1", plan="adaptive")),
    ("uq4-static", dict(workload="uq4", plan="static")),
    ("uq1-sharded-w1", dict(world=1, plan="static")),
)


def run_trace_audit(audits: Sequence[Tuple[str, Dict[str, Any]]] = None,
                    device=None
                    ) -> Tuple[List[Finding], List[Dict[str, Any]]]:
    """Run the audit matrix on ``device`` (``None``: the card); returns
    (findings, per-audit reports)."""
    findings: List[Finding] = []
    reports: List[Dict[str, Any]] = []
    for label, spec in (audits if audits is not None else DEFAULT_AUDITS):
        if "world" in spec:
            f, r = audit_sharded(label=label, device=device, **spec)
        else:
            f, r = audit_unsharded(label=label, device=device, **spec)
        findings.extend(f)
        reports.append(r)
    return findings, reports
