"""The union round's earlier-piece membership lookup: CUDA kernel + plain version.

A tuple lies in a join iff every base relation of the join holds its
projection onto that relation's attributes.  Each relation's membership
index is ``(attrs, s1, s2, kmax, n)``: its sorted attribute names, the
sorted salt-1 row fingerprints (:func:`fp32`, int64 in ``[0, 2^32)`` so
sorting and ``torch.searchsorted`` see the uint32 order), the salt-2
fingerprints in ``s1``'s order, the longest run of equal ``s1`` values and
the row count.

* :func:`member_lookup` — for one probing join of a round: the candidates'
  live mask ``acc`` AND NOT "contained in earlier piece q", for every piece
  of a :class:`MemberPlan`, and the number of (live candidate, earlier
  piece) pairs it looked up.  A piece's rejection-predicate mask, where it
  has one, is computed by the caller and passed in.
* :func:`contains` — one piece, no live mask: the membership verdicts.

A wrapper given CPU tensors runs the plain PyTorch version (``fp32`` +
``torch.searchsorted`` + the ``kmax`` window); given CUDA tensors it
launches ``member_lookup`` of ``csrc/member.cu`` on the current stream
(one kernel; the zeroing of its lookup counter is a memset) or raises.
A plan past one launch's capacities (more than 16 pieces, 64 relations,
96 columns or 256 column slots) takes one launch per run of pieces that
fits (``MemberPlan.launches``), each over the same live mask, and ANDs
their verdicts.  Each launch adds one to
``build.launch_counts["member_lookup"]``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .build import launch, load, stream

# (sorted attrs, sorted fp1, fp2 in fp1 order, kmax, nrows) of one relation
Rel = Tuple[Tuple[str, ...], torch.Tensor, torch.Tensor, int, int]
Rows = Dict[str, torch.Tensor]

_M32 = 0xFFFFFFFF
_FNV32 = 16777619


# ---------------------------------------------------------------------------
# 32-bit row fingerprints: the reference's uint32 arithmetic (murmur3-style
# finalizer, FNV-style column combine) done in int64 and masked to 32 bits
# after every step.  A product of two 32-bit values can pass 2^63; it wraps,
# and the low 32 bits it keeps are the uint32 product's.
# ---------------------------------------------------------------------------


def _mix32_consts(salt: int) -> Tuple[int, int, int]:
    return ((0x9E3779B9 * (salt + 1)) & _M32, 0x85EBCA6B, 0xC2B2AE35)


def mix32(x: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """Murmur3-style finalizer; int64 in, int64 in ``[0, 2^32)`` out."""
    add, m1, m2 = _mix32_consts(salt)
    z = ((x.to(torch.int64) & _M32) + add) & _M32
    z = ((z ^ (z >> 16)) * m1) & _M32
    z = ((z ^ (z >> 13)) * m2) & _M32
    return z ^ (z >> 16)


def fp32(cols: Sequence[torch.Tensor], salt: int) -> torch.Tensor:
    """Row fingerprint of a tuple of columns, as int64 in ``[0, 2^32)``."""
    acc = torch.zeros(cols[0].shape[0], dtype=torch.int64,
                      device=cols[0].device)
    for i, c in enumerate(cols):
        acc = ((acc * _FNV32) & _M32) ^ mix32(c, salt=salt * 1000 + i)
    return acc


def relation_index(attrs: Sequence[str], columns: Sequence, device) -> Rel:
    """The membership index of one relation from its columns (host arrays
    or tensors, in ``attrs`` order, which sets each column's salt).  They
    are moved to ``device`` here and dropped once fingerprinted, and the
    salt-1 fingerprints once sorted, so that the sort of the largest
    relation, where the build peaks, holds neither."""
    cols = [torch.as_tensor(c, device=device) for c in columns]
    fp1, fp2 = fp32(cols, salt=1), fp32(cols, salt=2)
    del cols
    s1, order = torch.sort(fp1, stable=True)
    del fp1
    kmax = 0
    if s1.shape[0]:
        kmax = int(torch.unique_consecutive(s1, return_counts=True)[1].max())
    return tuple(attrs), s1, fp2[order].contiguous(), kmax, int(s1.shape[0])


# ---------------------------------------------------------------------------
# the plan: the earlier pieces of one probing join
# ---------------------------------------------------------------------------

# the kernel's capacities (csrc/member.cu)
MAX_COLS, MAX_PAIRS, MAX_PIECES, MAX_REFS = 96, 64, 16, 256


class _Params(ctypes.Structure):
    """Host copy of ``MemberParams`` (``csrc/member.cu``), field for field."""
    _fields_ = [
        ("cols", ctypes.c_void_p * MAX_COLS),
        ("s1", ctypes.c_void_p * MAX_PAIRS),
        ("s2", ctypes.c_void_p * MAX_PAIRS),
        ("pred", ctypes.c_void_p * MAX_PIECES),
        ("qmask", ctypes.c_uint64 * MAX_PIECES),
        ("n", ctypes.c_int32 * MAX_PAIRS),
        ("kmax", ctypes.c_int32 * MAX_PAIRS),
        ("ref_off", ctypes.c_int32 * MAX_PAIRS),
        ("ref_len", ctypes.c_int32 * MAX_PAIRS),
        ("refs", ctypes.c_uint8 * MAX_REFS),
        ("acc", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("lookups", ctypes.c_void_p),
        ("B", ctypes.c_int32),
        ("npairs", ctypes.c_int32),
        ("npieces", ctypes.c_int32),
        ("group_log2", ctypes.c_int32),
    ]


def _fits(pieces: Sequence[Sequence[Rel]]) -> bool:
    """Whether one launch's parameters hold these pieces."""
    pairs = [rel for piece in pieces for rel in piece]
    lists = {rel[0] for rel in pairs}
    return (len(pieces) <= MAX_PIECES and len(pairs) <= MAX_PAIRS
            and len({a for attrs in lists for a in attrs}) <= MAX_COLS
            and sum(map(len, lists)) <= MAX_REFS)


def _split(pieces: Sequence[Sequence[Rel]]) -> List[Tuple[int, int]]:
    """Consecutive runs ``[lo, hi)`` of pieces, each as long as one
    launch's capacities allow (a piece beyond them alone: its launch
    raises)."""
    runs, lo = [], 0
    for hi in range(2, len(pieces) + 1):
        if not _fits(pieces[lo:hi]):
            runs.append((lo, hi - 1))
            lo = hi - 1
    return runs + [(lo, len(pieces))] if pieces else []


class MemberPlan:
    """The earlier pieces one lookup tests, in cover order: per piece the
    membership indexes of its base relations.  ``launches`` splits them
    into runs that each fit one launch (one run at every shape the
    benchmark serves); each run's kernel parameters other than the call's
    tensors are built once, at its first launch."""

    def __init__(self, pieces: Sequence[Sequence[Rel]]):
        self.pieces: List[List[Rel]] = [list(p) for p in pieces]
        self.launches: List[Tuple[int, int]] = _split(self.pieces)
        # per run: the parameter template and its candidate columns in
        # slot order
        self._params: Dict[Tuple[int, int], Tuple[_Params, List[str]]] = {}

    def _kernel_params(self, lo: int, hi: int) -> Tuple[_Params, List[str]]:
        if (lo, hi) in self._params:
            return self._params[(lo, hi)]
        pieces = self.pieces[lo:hi]
        if not _fits(pieces):
            raise ValueError(
                f"member_lookup: piece {lo} reads {len(pieces[0])} "
                f"relations; one launch takes at most {MAX_PAIRS} relations "
                f"over {MAX_COLS} columns in {MAX_REFS} column slots")
        if ctypes.sizeof(_Params) != load().repro_member_lookup_params_bytes():
            raise RuntimeError("member_lookup: the host copy of the kernel's "
                               "parameters does not match csrc/member.cu")
        pairs = [rel for piece in pieces for rel in piece]
        p = _Params()
        slot: Dict[str, int] = {}
        lists: Dict[Tuple[str, ...], int] = {}
        refs: List[int] = []
        for k, (attrs, s1, s2, kmax, n) in enumerate(pairs):
            if attrs not in lists:
                lists[attrs] = len(refs)
                for a in attrs:
                    refs.append(slot.setdefault(a, len(slot)))
            p.s1[k], p.s2[k] = s1.data_ptr(), s2.data_ptr()
            p.n[k], p.kmax[k] = int(n), int(kmax)
            p.ref_off[k], p.ref_len[k] = lists[attrs], len(attrs)
        for r, s in enumerate(refs):
            p.refs[r] = s
        k = 0
        for q, piece in enumerate(pieces):
            p.qmask[q] = ((1 << len(piece)) - 1) << k
            k += len(piece)
        p.npairs, p.npieces = len(pairs), len(pieces)
        p.group_log2 = min(5, max(0, (len(pairs) - 1).bit_length()))
        self._params[(lo, hi)] = (p, list(slot))
        return self._params[(lo, hi)]


# ---------------------------------------------------------------------------
# plain PyTorch version (the CPU path; the card's comparison target)
# ---------------------------------------------------------------------------


def contains_plain(rels: Sequence[Rel], rows: Rows,
                   pred: Optional[torch.Tensor] = None,
                   fp_cache: Optional[Dict[Tuple[str, ...], Tuple]] = None
                   ) -> torch.Tensor:
    """Whether each row lies in the join of ``rels`` (and ``pred`` holds).
    Pass one ``fp_cache`` dict across the joins probed with the same rows
    to fingerprint each attribute set once."""
    first = rows[next(iter(rows))]
    b = first.shape[0]
    res = (torch.ones(b, dtype=torch.bool, device=first.device)
           if pred is None else pred)
    for attrs, s1, s2, kmax, n in rels:
        if n == 0:
            return torch.zeros(b, dtype=torch.bool, device=first.device)
        hit = None if fp_cache is None else fp_cache.get(attrs)
        if hit is None:
            cols = [rows[a] for a in attrs]
            hit = (fp32(cols, salt=1), fp32(cols, salt=2))
            if fp_cache is not None:
                fp_cache[attrs] = hit
        q1, q2 = hit
        lo = torch.searchsorted(s1, q1, side="left")
        m = torch.zeros(b, dtype=torch.bool, device=first.device)
        for k in range(kmax):   # duplicate window (kmax is tiny)
            pos = torch.clamp(lo + k, max=n - 1)
            m = m | ((lo + k < n) & (s1[pos] == q1) & (s2[pos] == q2))
        res = res & m
    return res


def member_lookup_plain(plan: MemberPlan, rows: Rows,
                        acc: Optional[torch.Tensor] = None,
                        preds: Optional[Sequence[Optional[torch.Tensor]]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`member_lookup` as PyTorch ops, one piece after another."""
    first = rows[next(iter(rows))]
    live = (torch.ones(first.shape[0], dtype=torch.bool, device=first.device)
            if acc is None else acc)
    preds = [None] * len(plan.pieces) if preds is None else preds
    out = live
    fp_cache: Dict = {}
    for rels, pred in zip(plan.pieces, preds):
        out = out & ~contains_plain(rels, rows, pred, fp_cache)
    return out, live.sum() * len(plan.pieces)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_mask(what: str, m: torch.Tensor, b: int, dev) -> None:
    if (m.dtype != torch.bool or m.shape != (b,) or m.device != dev
            or not m.is_contiguous()):
        raise ValueError(f"member_lookup: {what} must be a contiguous bool "
                         f"({b},) tensor on {dev}, got {m.dtype} "
                         f"{tuple(m.shape)} on {m.device}")


def member_lookup(plan: MemberPlan, rows: Rows,
                  acc: Optional[torch.Tensor] = None,
                  preds: Optional[Sequence[Optional[torch.Tensor]]] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(acc & ~contained in any piece of plan, lookups)``.

    ``rows`` are the candidates' int32 columns of the output schema,
    ``acc`` their live mask (``None``: all live), ``preds`` one rejection
    predicate mask or ``None`` per piece.  ``lookups`` is a 0-d int64
    tensor: the live candidates times the pieces.  One launch per run of
    ``plan.launches``; no host sync."""
    first = rows[next(iter(rows))]
    dev = first.device
    if dev.type == "cpu":
        return member_lookup_plain(plan, rows, acc, preds)
    if dev.type != "cuda":
        raise ValueError(f"member_lookup: unsupported device {dev}")
    b = first.shape[0]
    if b >= 1 << 31:
        raise ValueError(f"member_lookup: {b} candidates; at most 2^31 - 1")
    preds = [None] * len(plan.pieces) if preds is None else list(preds)
    if len(preds) != len(plan.pieces):
        raise ValueError(f"member_lookup: {len(preds)} predicate masks for "
                         f"{len(plan.pieces)} pieces")
    if acc is not None:
        _check_mask("acc", acc, b, dev)
    for q, m in enumerate(preds):
        if m is not None:
            _check_mask(f"piece {q}'s predicate mask", m, b, dev)
    outs, counts = [], []
    for lo, hi in plan.launches:
        tmpl, cols = plan._kernel_params(lo, hi)
        p = _Params.from_buffer_copy(tmpl)
        for s, a in enumerate(cols):
            c = rows[a]
            if (c.dtype != torch.int32 or c.shape != (b,) or c.device != dev
                    or not c.is_contiguous()):
                raise ValueError(f"member_lookup: column {a!r} must be a "
                                 f"contiguous int32 ({b},) tensor on {dev}, "
                                 f"got {c.dtype} {tuple(c.shape)} on "
                                 f"{c.device}")
            p.cols[s] = c.data_ptr()
        for q in range(lo, hi):
            if preds[q] is not None:
                p.pred[q - lo] = preds[q].data_ptr()
        if acc is not None:
            p.acc = acc.data_ptr()
        out = torch.empty(b, dtype=torch.bool, device=dev)
        lookups = torch.empty((), dtype=torch.int64, device=dev)
        p.out, p.lookups, p.B = out.data_ptr(), lookups.data_ptr(), b
        launch("member_lookup", "repro_member_lookup", ctypes.addressof(p),
               stream(dev))
        outs.append(out)
        counts.append(lookups)
    # every run reads the same live mask, so the count is the plain
    # version's; the verdicts of a plan past one launch are ANDed
    for out in outs[1:]:
        outs[0] &= out
    for lookups in counts[1:]:
        counts[0] += lookups
    return outs[0], counts[0]

def contains(plan: MemberPlan, rows: Rows,
             pred: Optional[torch.Tensor] = None,
             fp_cache: Optional[Dict[Tuple[str, ...], Tuple]] = None
             ) -> torch.Tensor:
    """Whether each row lies in the plan's one piece (and ``pred`` holds):
    the plain version on CPU tensors (``fp_cache`` as in
    :func:`contains_plain`), the kernel on CUDA tensors."""
    first = rows[next(iter(rows))]
    if first.device.type == "cpu":
        return contains_plain(plan.pieces[0], rows, pred, fp_cache)
    return ~member_lookup(plan, rows, None, [pred])[0]
