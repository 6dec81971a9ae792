"""Torch backend — the Algorithm-1 union engine resident on the card.

Port of ``repro.core.backends.jax_backend`` (the probe-membership, static
plan engine).  Three layers, bottom-up:

* :class:`TorchTreeJoin` — one join prepared for batched Exact-Weight draws
  (chain ⊂ tree ⊂ §8.2 skeleton+residual).  Each non-root node keeps its
  rows sorted by a **composite mixed-radix int32 key** over the node's edge
  attributes (join-wide radices, so parent-side query keys pack identically)
  plus float32 prefix sums of the EW weights.  A draw is a root inverse-CDF
  pick, then per node one range probe through the CUDA kernels of
  :mod:`repro_torch.kernels.probe` (``probe_pick`` for uniform and residual
  nodes, ``sorted_probe`` + an inverse-CDF pick for weighted nodes) and the
  payload gathers.  Residual nodes accumulate the ``Π d/M`` acceptance.
* :class:`TorchJoinMembership` — batched "is tuple in join J" probes as
  sorted 32-bit row fingerprints (held as int64 so sorting and
  ``torch.searchsorted`` see the uint32 order) with a 32-bit secondary and a
  ``kmax``-wide duplicate window.
* :class:`TorchUnionSampler` — Algorithm-1 rounds driven from Python with
  every carry on the device: per-piece shortfall, FIFO ring-buffer surplus
  banks, dead-piece flags, the 6-wide stats vector and the per-piece
  counters.  Each round ends in one host sync (the ``total < n`` test), the
  cadence of the reference's ``fused_rounds="host"`` loop, so the exit round
  is exact; ``sample(n)`` adds one device→host fetch of the result.

Random numbers come from a **uniform source**: :class:`PhiloxUniforms`
(a ``torch.Generator`` on the device) in production; tests pass an object
with the same methods that replays the reference's JAX key schedule, and the
engine then reproduces the reference position for position.

Limits: ``method="ew"`` weights, non-negative dict-encoded values whose
packed edge domains fit in int32.  A join outside the int32 domain raises a
``ValueError`` naming it (the reference degrades such a join to the host).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...kernels.probe import (probe_pick, probe_pick_plain, sorted_probe,
                              sorted_probe_plain)
from ..index import Catalog
from ..join_sampler import JoinSampler
from ..joins import JoinSpec

_I32_LIM = 1 << 31
_M32 = 0xFFFFFFFF

Rows = Dict[str, torch.Tensor]


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


_FNV32 = 16777619


def fp32(cols: Sequence[torch.Tensor], salt: int) -> torch.Tensor:
    """Row fingerprint of a tuple of columns, as int64 in ``[0, 2^32)``."""
    acc = torch.zeros(cols[0].shape[0], dtype=torch.int64,
                      device=cols[0].device)
    for i, c in enumerate(cols):
        acc = ((acc * _FNV32) & _M32) ^ mix32(c, salt=salt * 1000 + i)
    return acc


# ---------------------------------------------------------------------------
# Composite-key encoding
# ---------------------------------------------------------------------------


def _attr_widths(spec: JoinSpec) -> Dict[str, int]:
    """Per-attribute mixed-radix width over *all* relations of the join, so
    a parent-side query key and a child-side index key for the same values
    coincide."""
    widths: Dict[str, int] = {}
    for node in spec.nodes:
        for a, c in node.relation.columns.items():
            lo = int(c.min(initial=0))
            if lo < 0:
                raise ValueError(
                    f"torch backend: attribute {a!r} of {node.relation.name!r} "
                    "has negative values; the device engine requires "
                    "non-negative dict-encoded columns")
            hi = int(c.max(initial=0))
            widths[a] = max(widths.get(a, 1), hi + 1)
    return widths


def _pack_np(cols: Sequence[np.ndarray], radices: Sequence[int]) -> np.ndarray:
    key = np.zeros(np.asarray(cols[0]).shape[0], dtype=np.int64)
    for c, w in zip(cols, radices):
        key = key * np.int64(w) + np.asarray(c, np.int64)
    return key


def _pack(rows: Rows, attrs: Sequence[str], radices: Sequence[int]
          ) -> torch.Tensor:
    """Device twin of :func:`_pack_np` in int32 (domain checked at build)."""
    key = torch.zeros_like(rows[attrs[0]])
    for a, w in zip(attrs, radices):
        key = key * w + rows[a]
    return key


def _as_i32(col: np.ndarray, what: str) -> np.ndarray:
    col = np.asarray(col, np.int64)
    if col.size and (int(col.min()) < 0 or int(col.max()) >= _I32_LIM):
        lo, hi = int(col.min()), int(col.max())
        raise ValueError(
            f"torch backend: {what} outside the int32 device domain "
            f"(values span [{lo}, {hi}], needing {max(hi, abs(lo)).bit_length()}"
            " bits but the device substrate has 31 usable bits)")
    return col.astype(np.int32)


def _inverse_cdf_pick(prefix: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor, u: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted pick within [lo, hi) via float32 prefix sums."""
    p_lo = prefix[lo.long()]
    tot = prefix[hi.long()] - p_lo
    tgt = p_lo + u * torch.clamp(tot, min=1e-30)
    pos = torch.searchsorted(prefix, tgt, side="right").to(torch.int32) - 1
    pos = torch.minimum(torch.maximum(pos, lo), torch.maximum(hi - 1, lo))
    return pos, tot > 0


# ---------------------------------------------------------------------------
# Device-resident tree join
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _NodeCfg:
    alias: str
    edge_attrs: Tuple[str, ...]
    radices: Tuple[int, ...]
    kind: str = "tree"               # "tree" | "residual" (§8.2 cycle closer)
    max_degree: int = 0              # M of the residual d/M acceptance
    uniform: bool = False            # all EW weights equal: pick by floor(u*d)


class TorchTreeJoin:
    """One join prepared for batched EW draws on ``device``.

    Acyclic joins draw with zero rejection.  Cyclic joins follow §8.2: EW
    weights over the skeleton, and each residual node resolves its edge with
    the same sorted-key range probe, a uniform pick among the ``d`` matches
    and an accumulated ``Π d/M`` acceptance (``M`` = the residual index's
    max degree).  A draw consumes ``n_streams`` rows of uniforms: the root,
    one per node, and (cyclic joins) the acceptance test.
    """

    def __init__(self, cat: Catalog, spec: JoinSpec, device=None):
        self.device = resolve_device(device)
        self.name = spec.name
        self.spec = spec
        self.attrs = tuple(spec.output_attrs)
        js = JoinSampler(cat, spec)                # host EW weights
        widths = _attr_widths(spec)
        dev = self.device
        self.node_cfgs: List[_NodeCfg] = []
        self.sorted_keys: List[torch.Tensor] = []
        self.perm: List[torch.Tensor] = []
        self.wprefix: List[torch.Tensor] = []
        self.cols: List[Dict[str, torch.Tensor]] = []
        produced = set(js.root_rel.attrs)
        for n in js.order[1:]:
            rel = n.relation
            radices = tuple(widths[a] for a in n.edge_attrs)
            dom = 1
            for w in radices:
                dom *= w
            if dom >= _I32_LIM:
                raise ValueError(
                    f"torch backend: packed edge-key domain of node {n.alias!r} "
                    f"(relation {rel.name!r}, edge attrs "
                    f"{tuple(n.edge_attrs)!r}) spans {dom} key combinations "
                    f"needing {int(dom).bit_length()} bits, but the device key "
                    "substrate is int32 (31 usable bits)")
            key = _pack_np([rel.columns[a] for a in n.edge_attrs], radices)
            perm = np.argsort(key, kind="stable")
            uniform = False
            if n.kind == "residual":
                # residual picks are uniform among matches: no prefix needed
                wp = np.zeros(1, dtype=np.float64)
            else:
                w = js.node_weights[n.alias]
                # equal-weight nodes (leaves always) pick uniformly among the
                # d matches: same law as the inverse-CDF pick, one search less
                uniform = (bool(w.size) and float(w.flat[0]) > 0
                           and bool(np.all(w == w.flat[0])))
                if uniform:
                    wp = np.zeros(1, dtype=np.float64)
                else:
                    wp = np.zeros(rel.nrows + 1, dtype=np.float64)
                    np.cumsum(w[perm], out=wp[1:])
            cols = {a: torch.as_tensor(_as_i32(c, f"{rel.name}.{a}"), device=dev)
                    for a, c in rel.columns.items() if a not in produced}
            produced.update(rel.attrs)
            self.node_cfgs.append(_NodeCfg(
                n.alias, tuple(n.edge_attrs), radices, kind=n.kind,
                max_degree=int(js.edges[n.alias].max_degree), uniform=uniform))
            self.sorted_keys.append(torch.as_tensor(key[perm].astype(np.int32),
                                                    device=dev))
            self.perm.append(torch.as_tensor(perm.astype(np.int64), device=dev))
            self.wprefix.append(torch.as_tensor(wp.astype(np.float32), device=dev))
            self.cols.append(cols)
        self.has_residual = any(c.kind == "residual" for c in self.node_cfgs)
        self.n_streams = len(self.node_cfgs) + 1 + int(self.has_residual)
        self.root_cols = {a: torch.as_tensor(_as_i32(c, f"root.{a}"), device=dev)
                          for a, c in js.root_rel.columns.items()}
        # float32 cast of the float64 host prefix (the reference's rounding)
        self.root_wprefix = torch.as_tensor(
            js.root_weight_prefix.astype(np.float32), device=dev)
        self.n_root = js.root_rel.nrows
        self._empty = js.is_empty()

    def is_empty(self) -> bool:
        return self._empty

    def draw(self, u: torch.Tensor, plain: bool = False
             ) -> Tuple[Rows, torch.Tensor, torch.Tensor]:
        """One batch of draws; ``u`` is ``(n_streams, batch)`` float32."""
        return self.draw_with_root(u, self.root_wprefix, self.root_cols,
                                   self.n_root, plain=plain)

    def draw_with_root(self, u: torch.Tensor, root_wprefix: torch.Tensor,
                       root_cols: Dict[str, torch.Tensor], n_root: int,
                       plain: bool = False
                       ) -> Tuple[Rows, torch.Tensor, torch.Tensor]:
        """Tree draw with a caller-supplied root slice.

        Returns ``(rows, accept, walk_ok)``: ``walk_ok`` marks walks whose
        every edge (tree and residual) had a match; ``accept`` additionally
        applies the residual ``Π d/M`` test, so ``walk_ok & ~accept`` are the
        residual rejections.  ``plain=True`` swaps the CUDA kernels for their
        plain PyTorch versions (the on-card comparison of the two)."""
        if u.dim() != 2 or u.shape[0] != self.n_streams:
            raise ValueError(f"{self.name}: draw needs ({self.n_streams}, batch)"
                             f" uniforms, got {tuple(u.shape)}")
        probe, pick = ((sorted_probe_plain, probe_pick_plain) if plain
                       else (sorted_probe, probe_pick))
        batch = u.shape[1]
        dev = u.device
        r_pos, ok = _inverse_cdf_pick(
            root_wprefix, torch.zeros(batch, dtype=torch.int32, device=dev),
            torch.full((batch,), n_root, dtype=torch.int32, device=dev), u[0])
        r_idx = r_pos.long()
        rows = {a: c[r_idx] for a, c in root_cols.items()}
        acc_ratio = torch.ones(batch, dtype=torch.float32, device=dev)
        for i, cfg in enumerate(self.node_cfgs):
            q = _pack(rows, cfg.edge_attrs, cfg.radices)
            if cfg.kind == "residual" or cfg.uniform:
                pos, d = pick(self.sorted_keys[i], q, u[i + 1])
                ok = ok & (d > 0)
                if cfg.kind == "residual":
                    acc_ratio = acc_ratio * (d.to(torch.float32)
                                             / float(max(cfg.max_degree, 1)))
            else:
                lo, hi = probe(self.sorted_keys[i], q)
                pos, alive = _inverse_cdf_pick(self.wprefix[i], lo, hi, u[i + 1])
                ok = ok & alive & (hi > lo)
            n_i = self.perm[i].shape[0]
            child = self.perm[i][torch.clamp(pos, 0, n_i - 1).long()]
            for a, c in self.cols[i].items():
                rows[a] = c[child]
        if not self.has_residual:
            return rows, ok, ok
        return rows, ok & (u[-1] < acc_ratio), ok


# ---------------------------------------------------------------------------
# Device-resident membership (sorted-row-fingerprint lookups)
# ---------------------------------------------------------------------------


class TorchJoinMembership:
    """Batched 'is tuple in join J' probes on the device.

    A tuple is in the join iff every base relation contains the tuple's
    projection onto that relation's attributes (the shared output schema
    makes connectivity automatic)."""

    def __init__(self, spec: JoinSpec, device=None):
        self.device = resolve_device(device)
        self.join_name = spec.name
        # (attrs, sorted fp1, fp2 in fp1 order, kmax, nrows) per base relation
        self.rels: List[Tuple[Tuple[str, ...], torch.Tensor, torch.Tensor,
                              int, int]] = []
        seen = set()
        for node in spec.nodes:
            rel = node.relation
            attrs = tuple(sorted(rel.attrs))
            # dedup on the host rowset cache key (relation name + attrs)
            if (rel.name, attrs) in seen:
                continue
            seen.add((rel.name, attrs))
            cols = [torch.as_tensor(_as_i32(rel.columns[a], f"{rel.name}.{a}"),
                                    device=self.device) for a in attrs]
            fp1, fp2 = fp32(cols, salt=1), fp32(cols, salt=2)
            s1, order = torch.sort(fp1, stable=True)
            kmax = 0
            if s1.shape[0]:
                kmax = int(torch.unique_consecutive(
                    s1, return_counts=True)[1].max())
            self.rels.append((attrs, s1, fp2[order].contiguous(), kmax,
                              int(rel.nrows)))

    def contains(self, rows: Rows,
                 fp_cache: Optional[Dict[Tuple[str, ...], Tuple]] = None
                 ) -> torch.Tensor:
        """Rows are device int32 columns of the output schema.  Pass one
        ``fp_cache`` dict across the joins probed with the same rows to
        fingerprint each attribute set once."""
        first = rows[next(iter(rows))]
        b = first.shape[0]
        res = torch.ones(b, dtype=torch.bool, device=first.device)
        for attrs, s1, s2, kmax, n in self.rels:
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


class TorchMembershipOracle:
    """Host-facing facade: numpy rows in, numpy booleans out."""

    def __init__(self, members: Dict[str, TorchJoinMembership],
                 output_attrs: Sequence[str], device):
        self.members = members
        self.output_attrs = list(output_attrs)
        self.device = device

    def contains(self, join_name: str, rows: Dict[str, np.ndarray]) -> np.ndarray:
        dev = {a: torch.as_tensor(_as_i32(rows[a], f"probe.{a}"),
                                  device=self.device)
               for a in self.output_attrs}
        if next(iter(dev.values())).shape[0] == 0:
            return np.zeros(0, dtype=bool)
        return self.members[join_name].contains(dev).cpu().numpy()

    def membership_matrix(self, rows: Dict[str, np.ndarray],
                          join_names: Optional[Sequence[str]] = None
                          ) -> np.ndarray:
        names = list(join_names) if join_names is not None else list(self.members)
        return np.stack([self.contains(nm, rows) for nm in names], axis=1)


class TorchBackend:
    """Device-resident engine state: tree joins + membership indexes."""

    name = "torch"

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec], device=None):
        self.device = resolve_device(device)
        self.cat = cat
        self.joins = list(joins)
        schemas = {tuple(sorted(j.output_attrs)) for j in self.joins}
        if len(schemas) > 1:
            raise ValueError(
                f"joins must share an output schema; got {sorted(schemas)}")
        self.attrs = list(self.joins[0].output_attrs)
        self.trees: Dict[str, TorchTreeJoin] = {}
        for j in self.joins:
            try:
                self.trees[j.name] = TorchTreeJoin(cat, j, device=self.device)
            except ValueError as e:
                raise ValueError(f"torch backend: join {j.name!r} cannot run "
                                 f"on the device: {e}") from e
        self._members: Optional[Dict[str, TorchJoinMembership]] = None
        self._oracle: Optional[TorchMembershipOracle] = None

    @property
    def members(self) -> Dict[str, TorchJoinMembership]:
        if self._members is None:
            self._members = {j.name: TorchJoinMembership(j, device=self.device)
                             for j in self.joins}
        return self._members

    def oracle(self) -> TorchMembershipOracle:
        if self._oracle is None:
            self._oracle = TorchMembershipOracle(self.members, self.attrs,
                                                 self.device)
        return self._oracle

    def supports_fused_rounds(self) -> bool:
        return True


# ---------------------------------------------------------------------------
# Uniform sources
# ---------------------------------------------------------------------------


class PhiloxUniforms:
    """Production uniform source: one ``torch.Generator`` on the device
    (Philox on CUDA).  A test may pass any object with the same two
    methods, e.g. one that replays the reference's JAX key schedule."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def round(self, slot: int, shapes: Sequence[Tuple[int, int]]
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Cover-selection uniforms ``(slot,)`` plus one ``(streams, batch)``
        block per join, cut from a single generator call."""
        sizes = [slot] + [s * b for s, b in shapes]
        flat = torch.rand(sum(sizes), generator=self.generator,
                          device=self.device)
        parts = torch.split(flat, sizes)
        return parts[0], [p.view(s, b) for p, (s, b) in zip(parts[1:], shapes)]

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator, device=self.device)


# ---------------------------------------------------------------------------
# Algorithm-1 rounds (static plan, probe membership)
# ---------------------------------------------------------------------------


# SamplerStats fields the engine accumulates as one device vector
_STAT_FIELDS = ("iterations", "candidate_draws", "cover_rejects",
                "residual_rejects", "pred_rejects", "dropped_slots")

# Per-piece round counters, one (nj, 5) device matrix per sample() call:
# candidate draws, cover-accepted rows, §8.2 residual rejections, rows
# drained from the surplus bank, and the post-round bank high-water mark.
PIECE_STAT_FIELDS = ("draws", "accepts", "residual_rejects",
                     "bank_drained", "bank_hwm")


def _cover_cum(probs_base: torch.Tensor, dead: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dead-masked, renormalised selection CDF + unreachable flag."""
    p = torch.where(dead, torch.zeros_like(probs_base), probs_base)
    s = p.sum()
    return torch.cumsum(p, 0) / torch.clamp(s, min=1e-30), s <= 0


PIECE_BATCH_SLACK = 1.5     # head-room of a piece's width over its share


def _piece_batches(probs, round_batch: int) -> Tuple[int, ...]:
    """Static per-join candidate widths for one round: proportional to the
    cover selection probability (head-room ``PIECE_BATCH_SLACK``, floor 256,
    multiples of 128, at most ``round_batch``) — the reference's
    ``balance="cover"``.  Undershoot is harmless: the shortfall carry tops a
    piece up next round."""
    nj = len(probs)
    p = np.maximum(np.asarray(probs, np.float64), 0)
    s = p.sum()
    if s <= 0:
        return (int(round_batch),) * nj
    out = []
    for j in range(nj):
        want = int(np.ceil(PIECE_BATCH_SLACK * (p[j] / s) * round_batch))
        b = max(256, ((want + 127) // 128) * 128)
        out.append(min(int(round_batch), b))
    return tuple(out)


def _emit_and_bank(out, pos, bank, head, count, cols, dt, ft, acc,
                   cap: int, trash: int, W: int):
    """Scatter one round's emission into ``out`` and roll the banks.

    Rows travel as ``(rows, A+1)`` int32 matrices (last column = home
    piece).  ``out`` has a trash row at index ``trash`` and ``bank`` is
    ``(nj, cap + 1, A+1)`` with a trash slot at ``cap``: masked scatters go
    there instead of being dropped.  Emission order: pieces in cover order;
    per piece the ``dt`` banked rows (FIFO, oldest first) then the ``ft``
    fresh rows.  Surplus accepts are pushed at the ring tail.  ``bank`` is
    updated in place; the banked rows are gathered before any push."""
    nj = dt.shape[0]
    dev = dt.device
    take = dt + ft
    base = pos + torch.cumsum(take, 0) - take        # exclusive prefix
    fresh_base = base + dt
    r = torch.arange(W, device=dev)
    bmask = r[None, :] < dt[:, None]
    bidx = (head[:, None] + r[None, :]) % cap
    bdst = torch.where(bmask, base[:, None] + r[None, :], trash).reshape(-1)
    jrow = torch.arange(nj, device=dev)[:, None]
    bvals = bank[jrow, bidx]                          # (nj, W, A+1) copy
    out[bdst] = bvals.reshape(nj * W, -1)
    push = torch.minimum(acc - ft, cap - (count - dt))
    for j in range(nj):
        cj = cols[j]
        rj = torch.arange(cj.shape[0], device=dev)
        fdst = torch.where(rj < ft[j], fresh_base[j] + rj, trash)
        pidx = torch.where((rj >= ft[j]) & (rj < ft[j] + push[j]),
                           (head[j] + count[j] + rj - ft[j]) % cap, cap)
        out[fdst] = cj
        bank[j][pidx] = cj
    head = (head + dt) % cap
    count = count - dt + push
    return pos + take.sum(), head, count


@dataclasses.dataclass
class _LoopState:
    """Device carry that persists across sample() calls."""

    owed: torch.Tensor      # (nj,) int64 per-piece carried shortfall
    dead: torch.Tensor      # (nj,) bool
    streak: torch.Tensor    # (nj,) int64 rounds without yield
    bank: torch.Tensor      # (nj, cap + 1, A+1) int32 ring banks (+ trash)
    head: torch.Tensor      # (nj,) int64
    count: torch.Tensor     # (nj,) int64


class _ReadySample:
    """Degenerate handle: the sample already exists."""

    def __init__(self, ss):
        self._ss = ss

    def result(self):
        return self._ss


class _PendingSample:
    """A finished round loop whose outputs still live on the device;
    ``result()`` does the one device→host fetch and builds the SampleSet."""

    def __init__(self, sampler, n, out, total, rounds, fail, stats, pstats,
                 shuffle):
        self._sampler = sampler
        self._n = int(n)
        self._out, self._total, self._rounds, self._fail = out, total, rounds, fail
        self._stats, self._pstats, self._shuffle = stats, pstats, shuffle
        self._done = None

    def result(self):
        if self._done is not None:
            return self._done
        s = self._sampler
        if self._fail:
            raise RuntimeError("all cover pieces unreachable")
        s.last_rounds = self._rounds
        if self._total < self._n:
            raise RuntimeError("TorchUnionSampler: top-up budget exhausted")
        from ..relation import fingerprint128
        from ..union_sampler import SampleSet
        with s._on_device():
            nj = len(s.order)
            counters = torch.cat([self._stats, self._pstats.reshape(-1)]).cpu()
            mat = self._out[:self._n][self._shuffle].cpu().numpy()
        s.last_host_syncs += 1
        s.host_syncs += 1
        counters = counters.numpy()
        for f, v in zip(_STAT_FIELDS, counters[:len(_STAT_FIELDS)]):
            setattr(s.stats, f, getattr(s.stats, f) + int(v))
        s._fold_piece_stats(counters[len(_STAT_FIELDS):].reshape(nj, -1),
                            samples=self._n)
        mat = mat.astype(np.int64)
        rows = {a: np.ascontiguousarray(mat[:, i]) for i, a in enumerate(s.attrs)}
        home = np.ascontiguousarray(mat[:, -1])
        fp = fingerprint128([rows[a] for a in sorted(s.attrs)])
        self._done = SampleSet(list(s.attrs), rows, home, fp, s.stats)
        return self._done


class TorchUnionSampler:
    """The multi-round Algorithm-1 loop with its state on the device.

    Per round (``piece_batches[j]`` candidates for join j):

    1. **multinomial cover selection** — per-slot categorical on the piece
       probabilities, histogrammed into per-piece targets and added to the
       shortfall carried from earlier rounds,
    2. **candidate generation for all joins** — one batched EW tree draw per
       join (cyclic pieces verify their residual edges in the same draw),
    3. **cover-membership acceptance** — a candidate of piece ``j`` survives
       iff no earlier cover piece contains it,
    4. **compaction and banking** — accepted rows ranked to the front per
       join (a cumsum scatter); each per-piece target is served first from
       that piece's FIFO surplus bank, then from the fresh accepts, and
       leftover accepts are pushed back into the bank.

    The shortfall of piece ``j`` stays assigned to piece ``j`` across
    rounds (never re-drawn from the selection distribution), and the banks
    are FIFOs over i.i.d. streams, so the output is uniform over the union.
    Rounds are driven from Python; each ends in one host sync.
    """

    def __init__(self, backend: TorchBackend, cover, seed: int = 0,
                 round_batch: int = 4096, stats=None, uniforms=None):
        self.backend = backend
        self.device = backend.device
        self.cover = cover
        self.order = list(cover.order)
        self.trees = [backend.trees[n] for n in self.order]
        self.attrs = tuple(backend.attrs)
        self.uniforms = (uniforms if uniforms is not None
                         else PhiloxUniforms(seed, self.device))
        self.round_batch = int(round_batch)
        # the reference's defaults: a piece yielding nothing for 8 rounds is
        # dead; a call gives up after 4096 rounds; banks hold 8 rounds' slots
        self.dead_rounds = 8
        self.max_rounds = 4096
        self.surplus_cap = 8 * self.round_batch
        if stats is None:
            from ..union_sampler import SamplerStats
            stats = SamplerStats()
        self.stats = stats
        base = np.maximum(np.asarray(cover.selection_probs(), np.float64), 0)
        s = base.sum()
        self._probs_base = torch.as_tensor(
            (base / s if s > 0 else base).astype(np.float32), device=self.device)
        self.piece_batches = _piece_batches(base, self.round_batch)
        self._pbatch = torch.as_tensor(self.piece_batches, dtype=torch.int64,
                                       device=self.device)
        self._slot_width = self.round_batch
        # per-piece bank drain cap per round (a semantics constant shared
        # with the reference: dt = min(need, count, W))
        self._drain_w = min(self.round_batch, 256)
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self.piece_stats = np.zeros((len(self.order), len(PIECE_STAT_FIELDS)),
                                    np.int64)
        self.last_rounds = 0
        self.total_rounds = 0
        self.last_host_syncs = 0
        self.host_syncs = 0
        self._state: Optional[_LoopState] = None

    # -- device and stream ---------------------------------------------------
    def _on_device(self):
        """Pin the sampler's device and CUDA stream (a producer thread starts
        on the default stream of device 0 otherwise)."""
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    # -- one round -------------------------------------------------------------
    def _round_core(self, probs_cum: torch.Tensor, owed: torch.Tensor,
                    extra: torch.Tensor):
        """Selection + draws + earlier-piece rejection + compaction.

        Returns per join the accepted-compacted ``(B_j, A+1)`` matrices plus
        the (walk_ok, residual, accepted) counts and the per-piece need =
        carry + this round's targets."""
        nj = len(self.trees)
        dev = self.device
        members = [self.backend.members[n] for n in self.order]
        u_sel, u_joins = self.uniforms.round(
            self._slot_width,
            [(t.n_streams, b) for t, b in zip(self.trees, self.piece_batches)])
        pick = torch.clamp(torch.searchsorted(probs_cum, u_sel, side="right"),
                           0, nj - 1)
        valid = (torch.arange(self._slot_width, device=dev) < extra).to(torch.int64)
        need = owed + torch.zeros(nj, dtype=torch.int64,
                                  device=dev).scatter_add_(0, pick, valid)
        cols, okc, resc, accc = [], [], [], []
        for j, tree in enumerate(self.trees):
            bj = self.piece_batches[j]
            rows, acc, walk_ok = tree.draw(u_joins[j])
            resc.append(walk_ok.sum() - acc.sum())
            fp_cache: Dict = {}
            for q in range(j):             # pieces earlier in cover order
                acc = acc & ~members[q].contains(rows, fp_cache)
            dst = torch.where(acc, torch.cumsum(acc, 0) - 1, bj)
            mat = torch.stack([rows[a] for a in self.attrs]
                              + [torch.full((bj,), j, dtype=torch.int32,
                                            device=dev)], dim=1)
            col = torch.zeros((bj + 1, mat.shape[1]), dtype=torch.int32,
                              device=dev)
            col[dst] = mat
            cols.append(col[:bj])
            okc.append(walk_ok.sum())
            accc.append(acc.sum())
        return (cols, torch.stack(okc), torch.stack(resc), torch.stack(accc),
                need)

    def _init_state(self) -> _LoopState:
        nj, cap, dev = len(self.order), self.surplus_cap, self.device
        z = lambda: torch.zeros(nj, dtype=torch.int64, device=dev)  # noqa: E731
        return _LoopState(
            owed=z(), dead=torch.zeros(nj, dtype=torch.bool, device=dev),
            streak=z(),
            bank=torch.zeros((nj, cap + 1, len(self.attrs) + 1),
                             dtype=torch.int32, device=dev),
            head=z(), count=z())

    def sample_async(self, n: int):
        """Run the round loop for ``sample(n)``; the returned handle's
        ``result()`` does the one device→host fetch (the serve tier
        dispatches call *k+1* before draining call *k*)."""
        from ..union_sampler import empty_sample_set
        if n <= 0:
            return _ReadySample(empty_sample_set(list(self.attrs), self.stats))
        with self._on_device():
            return self._run_loop(int(n))

    def _run_loop(self, n: int) -> _PendingSample:
        dev = self.device
        nj, cap = len(self.order), self.surplus_cap
        W = min(self._drain_w, cap)
        bt = int(sum(self.piece_batches))
        if self._state is None:
            self._state = self._init_state()
        st = self._state
        out = torch.zeros((n + 1, len(self.attrs) + 1), dtype=torch.int32,
                          device=dev)               # row n is the trash row
        total = torch.zeros((), dtype=torch.int64, device=dev)
        fail = torch.zeros((), dtype=torch.bool, device=dev)
        stats = torch.zeros(len(_STAT_FIELDS), dtype=torch.int64, device=dev)
        pstats = torch.zeros((nj, len(PIECE_STAT_FIELDS)), dtype=torch.int64,
                             device=dev)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        rounds = 0
        self.last_host_syncs = 0
        while True:
            probs_cum, bad = _cover_cum(self._probs_base, st.dead)
            extra = torch.clamp(n - total - st.owed.sum(), 0, self._slot_width)
            cols, okc, resc, accc, need = self._round_core(probs_cum, st.owed,
                                                           extra)
            # bank take (FIFO, capped) → fresh take → carried shortfall
            dt = torch.minimum(torch.minimum(need, st.count),
                               torch.full_like(need, self._drain_w))
            ft = torch.minimum(need - dt, accc)
            total, head, count = _emit_and_bank(
                out, total, st.bank, st.head, st.count, cols, dt, ft, accc,
                cap, n, W)
            shortfall = need - dt - ft
            # dead-piece bookkeeping: stray picks on dead pieces are dropped;
            # a live piece that keeps a target but yields nothing for
            # dead_rounds rounds is empty in reality — drop it
            dropped = torch.where(st.dead, shortfall, zero).sum()
            shortfall = torch.where(st.dead, zero, shortfall)
            trig = (shortfall > 0) & (accc == 0) & (count == 0)
            streak = torch.where(st.dead, st.streak,
                                 torch.where(trig, st.streak + 1, zero))
            newly = ~st.dead & (streak >= self.dead_rounds)
            dropped = dropped + torch.where(newly, shortfall, zero).sum()
            shortfall = torch.where(newly, zero, shortfall)
            stats += torch.stack([
                zero + bt, zero + bt,
                okc.sum() - resc.sum() - accc.sum(), resc.sum(), zero,
                dropped])
            pstats = torch.stack([pstats[:, 0] + self._pbatch,
                                  pstats[:, 1] + accc, pstats[:, 2] + resc,
                                  pstats[:, 3] + dt,
                                  torch.maximum(pstats[:, 4], count)], dim=1)
            st.owed, st.dead, st.streak = shortfall, st.dead | newly, streak
            st.head, st.count = head, count
            fail = fail | bad
            rounds += 1
            # the one host sync of the round: loop test (total < n, ~fail)
            got, failed = torch.stack([total, fail.to(torch.int64)]).tolist()
            self.last_host_syncs += 1
            self.host_syncs += 1
            if failed or got >= n or rounds >= self.max_rounds:
                break
        self.total_rounds += rounds
        shuffle = self.uniforms.permutation(n)
        return _PendingSample(self, n, out, got, rounds, bool(failed), stats,
                              pstats, shuffle)

    def sample(self, n: int):
        return self.sample_async(n).result()

    def _fold_piece_stats(self, p: np.ndarray, samples: int = 0) -> None:
        p = np.asarray(p, np.int64)
        self.piece_stats[:, :4] += p[:, :4]
        self.piece_stats[:, 4] = np.maximum(self.piece_stats[:, 4], p[:, 4])
        self.stats.samples_emitted += int(samples)
