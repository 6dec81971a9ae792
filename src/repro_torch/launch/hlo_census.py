"""Census of a traced step: FLOPs, bytes and collectives, with depth scaling.

The counterpart of the reference's ``repro/launch/hlo_census.py``, under
the same name so that a reader finds it.  The reference parses XLA's
post-optimisation HLO text; the port produces none, so this module reads a
**traced step** instead: the step runs once on meta tensors
(:mod:`repro_torch.launch.dryrun`) under one
:class:`Census` dispatch mode, which sees every aten and custom operator
the eager program issues, its backward included:

* **FLOPs** from ``torch.utils.flop_counter``'s formulas (matmuls,
  convolutions, attention; B4 through its registered formula).
  Elementwise FLOPs are not counted, as in the reference;
* **bytes accessed**: each operator's tensor operands plus its results.
  Eager PyTorch fuses nothing, so this is the eager program's own traffic.
  Views (``func.is_view``) and uninitialised allocations move no bytes and
  are skipped, as the reference skips ``bitcast`` and ``parameter``;
* **HBM bytes**: the part of that traffic in tensors of at least
  :data:`L2_RESIDENT_LIMIT` bytes (the reference's ``VMEM_THRESHOLD``);
* **collectives** by kind from
  ``torch.distributed.tensor.debug.CommDebugMode`` (counts) and the input
  operands of each c10d operator the census sees (bytes), as the
  reference counts an HLO collective's operands: an all-gather counts its
  shard, an all-reduce or a reduce-scatter its whole input.  The in-place
  c10d forms also take their output buffer (``_allgather_base_(output,
  input)``, ``reduce_scatter_``, ``recv_``); it is not an operand here,
  so the in-place and functional forms count alike.

``while_trip_counts`` has no counterpart: every layer loop of the port is
Python, so a trace holds every layer, and the field is ``{}``.  What stands
in for the reference's trip scaling is :func:`scale_census`: the dry-run
runs one and two blocks of a model over its full-depth tensors and extends
the difference to the full depth.  ``top_contributors`` ranks by aten operator, since the port's
models are plain functions, not ``nn.Module``\\ s.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# Traffic in tensors of at least 8 MiB (the reference's VMEM_THRESHOLD) is
# counted as HBM traffic: a smaller tensor may be served from the H100's
# 50 MB L2 between the operators that touch it.
L2_RESIDENT_LIMIT = 8 * 2**20

# c10d operator (base name) -> the reference's collective kind
_COLL_KIND = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast",
}
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "detach", "lift_fresh", "wait_tensor",
               "_wrap_tensor_autograd"}

Tensors = Tuple[Tuple[Tuple[int, ...], str], ...]
# (operator, its input tensors, its output tensors, collective kind or None)
Key = Tuple[str, Tensors, Tensors, Optional[str]]


def _kind(func) -> Optional[str]:
    ns = func.namespace
    if ns not in ("c10d", "_c10d_functional", "c10d_functional"):
        return None
    # not a collective: a functional collective's ``wait_tensor`` and
    # ``_wrap_tensor_autograd``; one missing from the table is caught by
    # :func:`census`' check against ``CommDebugMode``
    return _COLL_KIND.get(func._schema.name.split("::")[-1])


def _is_output_arg(func, arg: str) -> bool:
    """A c10d argument that is the collective's output buffer."""
    return arg.startswith("output") or (
        arg == "tensors" and func._schema.name.endswith("::recv_"))


def _operands(func, args, kwargs) -> list:
    """The arguments an operator reads: all of them, but for a collective
    only its inputs (not the in-place forms' output buffers)."""
    if _kind(func) is None:
        return [args, kwargs]
    names = [a.name for a in func._schema.arguments]
    return ([v for a, v in zip(names, args) if not _is_output_arg(func, a)]
            + [v for a, v in kwargs.items() if not _is_output_arg(func, a)])


def _tensors(tree) -> Tensors:
    return tuple((tuple(t.shape), str(t.dtype).split(".")[-1])
                 for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _tensor_bytes(shape: Sequence[int], dtype: str) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * getattr(torch, dtype).itemsize


@dataclasses.dataclass
class CensusResult:
    flops: float
    bytes_accessed: float        # every operator's operands + results
    hbm_bytes: float             # the part in tensors >= L2_RESIDENT_LIMIT
    # by kind: the collectives' input operands (an all-gather's shard)
    collective_bytes: Dict[str, float]
    collective_counts: Dict[str, float]
    while_trip_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    # per record: count, FLOPs per call (the scaling and top_contributors)
    records: Dict[Key, int] = dataclasses.field(default_factory=dict,
                                                repr=False)
    flops_of: Dict[Key, float] = dataclasses.field(default_factory=dict,
                                                   repr=False)

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    @classmethod
    def from_records(cls, records: Dict[Key, int], flops_of: Dict[Key, float],
                     counts: Dict[str, float]) -> "CensusResult":
        flops = byts = hbm = 0.0
        coll: Dict[str, float] = {}
        for key, n in records.items():
            _, ins, outs, kind = key
            sizes = [_tensor_bytes(s, d) for s, d in ins + outs]
            flops += n * flops_of.get(key, 0.0)
            byts += n * sum(sizes)
            hbm += n * sum(b for b in sizes if b >= L2_RESIDENT_LIMIT)
            if kind is not None:
                coll[kind] = coll.get(kind, 0.0) + n * sum(
                    _tensor_bytes(s, d) for s, d in ins)
        return cls(flops, byts, hbm, coll, dict(counts), {}, dict(records),
                   dict(flops_of))


class Census(TorchDispatchMode):
    """Records every operator the step issues as ``(name, tensor shapes and
    dtypes, collective kind)`` with its count and FLOPs."""

    def __init__(self):
        super().__init__()
        self.records: Dict[Key, int] = collections.Counter()
        self.flops_of: Dict[Key, float] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        if func.is_view or name in _NO_TRAFFIC or func.namespace == "prim":
            return out
        key = (f"{func.namespace}.{name}",
               _tensors(_operands(func, args, kwargs)), _tensors(out),
               _kind(func))
        if key not in self.flops_of:
            f = flop_registry.get(func.overloadpacket)
            self.flops_of[key] = float(f(*args, **kwargs, out_val=out)) \
                if f is not None else 0.0
        self.records[key] += 1
        return out


def census(fn, *args, **kwargs) -> Tuple[object, CensusResult]:
    """Run ``fn(*args, **kwargs)`` under a :class:`Census` and
    ``CommDebugMode``; returns (its result, the census)."""
    from torch.distributed.tensor.debug import CommDebugMode
    comm = CommDebugMode()
    cs = Census()
    with comm, cs:
        out = fn(*args, **kwargs)
    counts: Dict[str, float] = {}
    for op, n in comm.get_comm_counts().items():
        kind = _COLL_KIND.get(str(op).split(".")[-1], "other")
        counts[kind] = counts.get(kind, 0.0) + n
    seen: Dict[str, float] = {}
    for (_, _, _, kind), n in cs.records.items():
        if kind is not None:
            seen[kind] = seen.get(kind, 0.0) + n
    if seen != counts:
        raise RuntimeError(f"census: the collectives seen ({seen}) differ "
                           f"from CommDebugMode's ({counts})")
    return out, CensusResult.from_records(cs.records, cs.flops_of, counts)


def _affine(a: float, b: float, units: int) -> float:
    """The value at ``units`` of a quantity that is ``a`` at one unit and
    ``b`` at two."""
    return a + (units - 1) * (b - a)


def scale_census(one: CensusResult, two: CensusResult, units: int
                 ) -> CensusResult:
    """The census at ``units`` blocks from the traces of one and two.

    Both traces must hold the whole model's tensors (the stacked ``(L, …)``
    parameters, caches and optimizer slots at full depth) and run one and
    two of its blocks: then every record has the same shapes at any depth,
    a per-block record's count grows by the same amount with each block
    and every other record's stays, so each count is extended affinely.
    A count that would not be a whole number ≥ 0 raises ``ValueError``."""
    if units < 1:
        raise ValueError(f"scale_census: units {units} < 1")
    recs: Dict[Key, int] = {}
    flops_of = {**two.flops_of, **one.flops_of}
    for key in one.records.keys() | two.records.keys():
        n = _affine(one.records.get(key, 0), two.records.get(key, 0), units)
        if n < 0 or n != int(n):
            raise ValueError(f"scale_census: {key[0]} counts "
                             f"{one.records.get(key, 0)}, "
                             f"{two.records.get(key, 0)}")
        if n:
            recs[key] = int(n)
    counts = {k: _affine(one.collective_counts.get(k, 0.0),
                         two.collective_counts.get(k, 0.0), units)
              for k in one.collective_counts.keys()
              | two.collective_counts.keys()}
    return CensusResult.from_records(
        recs, {k: flops_of[k] for k in recs},
        {k: v for k, v in counts.items() if v})


def top_contributors(cs: CensusResult, k: int = 20):
    """Heaviest aten operators by bytes and by FLOPs.

    Returns (by_bytes, by_flops): lists of (total, calls, operator name)."""
    byts: Dict[str, float] = collections.defaultdict(float)
    flops: Dict[str, float] = collections.defaultdict(float)
    calls: Dict[str, int] = collections.defaultdict(int)
    for key, n in cs.records.items():
        op = key[0]
        calls[op] += n
        byts[op] += n * sum(_tensor_bytes(s, d) for s, d in key[1] + key[2])
        flops[op] += n * cs.flops_of.get(key, 0.0)
    by_bytes = sorted(((v, calls[op], op) for op, v in byts.items()),
                      key=lambda t: -t[0])
    by_flops = sorted(((v, calls[op], op) for op, v in flops.items() if v),
                      key=lambda t: -t[0])
    return by_bytes[:k], by_flops[:k]
