"""Torch backend — the Algorithm-1 union engine resident on the card.

Port of ``repro.core.backends.jax_backend``: probe or record membership,
the static or adaptive round plan, §8.3 predicates.  Three layers,
bottom-up:

* :class:`TorchTreeJoin` — one join prepared for batched Exact-Weight draws
  (chain ⊂ tree ⊂ §8.2 skeleton+residual).  Each non-root node keeps its
  rows sorted by a **composite mixed-radix int32 key** over the node's edge
  attributes (join-wide radices, so parent-side query keys pack identically)
  plus float32 prefix sums of the EW weights.  A draw is a root inverse-CDF
  pick, then per node one range probe through the CUDA kernels of
  :mod:`repro_torch.kernels.probe` (``probe_pick`` for uniform and residual
  nodes, ``sorted_probe`` + an inverse-CDF pick for weighted nodes) and the
  payload gathers.  Residual nodes accumulate the ``Π d/M`` acceptance.  A
  §8.3 pushdown becomes validity masks over base indexes that the
  catalog's device cache shares across flavours.
* :class:`TorchJoinMembership` — batched "is tuple in join J" probes as
  sorted 32-bit row fingerprints (held as int64 so sorting and
  ``torch.searchsorted`` see the uint32 order) with a 32-bit secondary and a
  ``kmax``-wide duplicate window, ANDed with a join's rejection predicates.
* :class:`TorchUnionSampler` — Algorithm-1 rounds with every carry on the
  device in static buffers: per-piece shortfall, FIFO ring-buffer surplus
  banks, dead-piece flags, the stats vector and the per-piece counters.
  One round is one step with no host sync, gated off once the call is
  done.  ``fused_rounds="device"`` (the default, the reference's default
  engine) captures that step as a CUDA graph per capacity class and
  replays it in chunks of rounds, one host sync per chunk; the uniforms of
  the gated rounds are rewound, so the stream goes on where the host loop's
  would.  ``fused_rounds="host"`` syncs after every round (the reference's
  debugging twin).  The two give bit-identical samples, stats and carry;
  ``sample(n)`` adds one device→host fetch of the result, where the
  engine's counters also reach the metrics registry (:mod:`repro_torch.obs`).
  ``sample_async(n)`` returns with the call's first chunk in flight, so the
  drain of the call before it runs on the host meanwhile.
  :class:`TorchRecordUnionSampler` keeps the lazy ``orig_join`` record as a
  sorted-fingerprint multiset instead, host-driven in either mode.
* :class:`TorchCandidateSource` — fixed-width device rounds of one tree
  join, buffered on the host and served in slices to the host-driven
  ONLINE-UNION sampler (``TorchBackend.source``).

Random numbers come from a **uniform source**: :class:`PhiloxUniforms`
(a ``torch.Generator`` on the device, registered with the engine's CUDA
graphs) in production; tests pass an object with the same methods that
replays the reference's JAX key schedule, and the engine then reproduces
the reference position for position (on the card the device loop needs the
Philox source: a graph cannot replay host-made uniforms).

Limits: ``method="ew"`` weights, non-negative dict-encoded values whose
packed edge domains fit in int32.  A join outside the int32 domain degrades
to a host candidate source, as in the reference (:class:`TorchBackend`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ... import obs
from ...device import resolve_device
from ...kernels import build, member
from ...kernels.member import fp32, mix32  # noqa: F401  (re-exported)
from ...kernels.probe import (probe_pick, probe_pick_plain, sorted_probe,
                              sorted_probe_plain)
from .. import planner
from ..index import Catalog
from ..join_sampler import JoinSampler
from ..joins import JoinSpec
from ..predicates import compile_preds_torch, relation_mask
from .base import Backend

_I32_LIM = 1 << 31

Rows = Dict[str, torch.Tensor]


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


def _device_index_cache(cat: Catalog) -> Dict:
    """Catalog-level cache of device sorted indexes and column uploads,
    keyed by relation identity.  Pushdown flavours of one base join (the UQ2
    regime: one base chain, several overlapping §8.3 filters) share the base
    relation's sorted keys, permutation and payload tensors instead of
    re-sorting and re-uploading per flavour.  Entries hold a reference to
    the relation, so an ``id()`` key cannot be reused after collection."""
    cache = cat.__dict__.get("_device_index_cache")
    if cache is None:
        cache = cat.__dict__["_device_index_cache"] = {}
    return cache


def _cached_node_index(cache: Dict, rel, edge_attrs: Tuple[str, ...],
                       radices: Tuple[int, ...], device):
    """Sorted composite-key index over ``rel``: host permutation, device
    sorted keys and device permutation, shared through the catalog cache.
    The caller has already checked that the packed domain fits in int32."""
    k = ("idx", id(rel), rel.name, edge_attrs, radices, str(device))
    hit = cache.get(k)
    if hit is None:
        key = _pack_np([rel.columns[a] for a in edge_attrs], radices)
        perm = np.argsort(key, kind="stable")
        hit = (rel, perm,
               torch.as_tensor(key[perm].astype(np.int32), device=device),
               torch.as_tensor(perm.astype(np.int64), device=device))
        cache[k] = hit
    return hit[1], hit[2], hit[3]


def _cached_col(cache: Dict, rel, attr: str, device) -> torch.Tensor:
    """Device upload of one relation column, shared across flavours."""
    k = ("col", id(rel), rel.name, attr, str(device))
    hit = cache.get(k)
    if hit is None:
        hit = (rel, torch.as_tensor(_as_i32(rel.columns[attr],
                                            f"{rel.name}.{attr}"),
                                    device=device))
        cache[k] = hit
    return hit[1]


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

    A §8.3 pushdown (``spec.pushdown_base`` and ``spec.pushed_preds``) is
    rebuilt as validity masks over the base relations: tree nodes index the
    base relation (shared across flavours through the catalog cache) with
    the filtered EW weights scattered onto the base rows, so masked-out rows
    have weight 0 and a flat prefix region that the inverse-CDF pick never
    lands in.  Should the base relations overflow a device limit that the
    filtered ones meet, the join is indexed over the filtered relations
    instead: the same sampling law without the sharing.
    """

    def __init__(self, cat: Catalog, spec: JoinSpec, device=None):
        self.device = resolve_device(device)
        self.name = spec.name
        self.spec = spec
        self.attrs = tuple(spec.output_attrs)
        if spec.pushdown_base is not None and spec.pushed_preds:
            try:
                self._build(cat, spec, spec.pushdown_base, spec.pushed_preds)
                return
            except ValueError:
                pass
        self._build(cat, spec, None, ())

    def _build(self, cat: Catalog, spec: JoinSpec, base: Optional[JoinSpec],
               preds: Tuple) -> None:
        """``base is None`` indexes ``spec``'s own relations.  Otherwise
        ``spec`` is a pushdown of ``base``: tree nodes index the base
        relations under masks; residual (§8.2) nodes keep per-flavour
        *filtered* indexes, since their match count ``d`` feeds the
        ``Π d/M`` acceptance; and any mask turns off the ``uniform``
        floor(u·d) shortcut, which picks among index rows."""
        js = JoinSampler(cat, spec)                # host EW weights
        dev = self.device
        masked = base is not None
        widths = _attr_widths(base if masked else spec)
        # masked nodes share the catalog's device indexes; the others build
        # their own (a throwaway cache)
        shared = _device_index_cache(cat) if masked else None

        def _source(n, nrows: int):
            """(relation to index, validity mask or None, index cache)."""
            if not masked or n.kind == "residual":
                return n.relation, None, {}
            rel_b = {bn.alias: bn.relation for bn in base.nodes}.get(n.alias)
            if rel_b is None:
                raise ValueError(
                    f"torch backend: pushdown base of {spec.name!r} has no "
                    f"node {n.alias!r}")
            m = relation_mask(rel_b, preds)
            if m is None:
                m = np.ones(rel_b.nrows, dtype=bool)
            if int(m.sum()) != nrows:
                raise ValueError(
                    f"torch backend: pushdown provenance of {spec.name!r} is "
                    f"stale for node {n.alias!r} (mask keeps {int(m.sum())} "
                    f"rows, the filtered relation has {nrows})")
            return rel_b, m, shared

        def _on_rows(w, rel, m):
            """Weights of the filtered rows placed on ``rel``'s rows (the
            filter keeps row order); masked-out rows get weight 0."""
            if m is None:
                return np.asarray(w, np.float64)
            wb = np.zeros(rel.nrows, dtype=np.float64)
            wb[np.nonzero(m)[0]] = w
            return wb

        self.node_cfgs: List[_NodeCfg] = []
        self.sorted_keys: List[torch.Tensor] = []
        self.perm: List[torch.Tensor] = []
        self.wprefix: List[torch.Tensor] = []
        self.cols: List[Dict[str, torch.Tensor]] = []
        produced = set(js.root_rel.attrs)
        for n in js.order[1:]:
            radices = tuple(widths[a] for a in n.edge_attrs)
            dom = 1
            for w in radices:
                dom *= w
            if dom >= _I32_LIM:
                raise ValueError(
                    f"torch backend: packed edge-key domain of node {n.alias!r} "
                    f"(relation {n.relation.name!r}, edge attrs "
                    f"{tuple(n.edge_attrs)!r}) spans {dom} key combinations "
                    f"needing {int(dom).bit_length()} bits, but the device key "
                    "substrate is int32 (31 usable bits)")
            rel, m, cache = _source(n, n.relation.nrows)
            perm, skeys, perm_dev = _cached_node_index(
                cache, rel, tuple(n.edge_attrs), radices, dev)
            # residual picks are uniform among matches: no prefix.  Equal-
            # weight nodes (leaves always) pick uniformly among the d matches:
            # the inverse-CDF pick's law, one search less; it picks among
            # index rows, so any mask turns it off
            uniform = False
            if n.kind != "residual":
                w = _on_rows(js.node_weights[n.alias], rel, m)
                uniform = ((m is None or bool(m.all())) and bool(w.size)
                           and float(w.flat[0]) > 0
                           and bool(np.all(w == w.flat[0])))
            if n.kind == "residual" or uniform:
                wp = np.zeros(1, dtype=np.float64)
            else:
                wp = np.zeros(rel.nrows + 1, dtype=np.float64)
                np.cumsum(w[perm], out=wp[1:])
            self.node_cfgs.append(_NodeCfg(
                n.alias, tuple(n.edge_attrs), radices, kind=n.kind,
                max_degree=int(js.edges[n.alias].max_degree), uniform=uniform))
            self.sorted_keys.append(skeys)
            self.perm.append(perm_dev)
            self.wprefix.append(torch.as_tensor(wp.astype(np.float32),
                                                device=dev))
            self.cols.append({a: _cached_col(cache, rel, a, dev)
                              for a in rel.attrs if a not in produced})
            produced.update(rel.attrs)
        self.has_residual = any(c.kind == "residual" for c in self.node_cfgs)
        self.n_streams = len(self.node_cfgs) + 1 + int(self.has_residual)
        rel0, m0, cache = _source(js.order[0], js.root_rel.nrows)
        if m0 is None:
            wp0 = js.root_weight_prefix
        else:
            wp0 = np.zeros(rel0.nrows + 1, dtype=np.float64)
            np.cumsum(_on_rows(np.diff(np.asarray(js.root_weight_prefix,
                                                  np.float64)), rel0, m0),
                      out=wp0[1:])
        self.root_cols = {a: _cached_col(cache, rel0, a, dev)
                          for a in rel0.columns}
        self.n_root = rel0.nrows
        # float32 cast of the float64 host prefix (the reference's rounding):
        # equal float64 neighbours stay equal, so a masked run stays flat
        self.root_wprefix = torch.as_tensor(
            np.asarray(wp0, np.float64).astype(np.float32), device=dev)
        self.masked = masked
        self._empty = js.is_empty()

    def is_empty(self) -> bool:
        return self._empty

    def draw(self, u: torch.Tensor, plain: bool = False,
             skeleton: bool = False) -> Tuple[torch.Tensor, ...]:
        """One batch of draws; ``u`` is ``(n_streams, batch)`` float32."""
        return self.draw_with_root(u, self.root_wprefix, self.root_cols,
                                   self.n_root, plain=plain, skeleton=skeleton)

    def draw_with_root(self, u: torch.Tensor, root_wprefix: torch.Tensor,
                       root_cols: Dict[str, torch.Tensor], n_root: int,
                       plain: bool = False, skeleton: bool = False
                       ) -> Tuple[torch.Tensor, ...]:
        """Tree draw with a caller-supplied root slice.

        Returns ``(rows, accept, walk_ok)``: ``walk_ok`` marks walks whose
        every edge (tree and residual) had a match; ``accept`` additionally
        applies the residual ``Π d/M`` test, so ``walk_ok & ~accept`` are the
        residual rejections.  ``skeleton=True`` adds a fourth mask, the walks
        whose every tree edge had a match, so ``skeleton & ~walk_ok`` are
        the residual misses (d = 0).  ``plain=True`` swaps the CUDA kernels
        for their plain PyTorch versions (the on-card comparison of the
        two)."""
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
        skel = None
        for i, cfg in enumerate(self.node_cfgs):
            if cfg.kind == "residual" and skel is None:
                skel = ok               # residual nodes come after the tree's
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
        out = ((rows, ok, ok) if not self.has_residual
               else (rows, ok & (u[-1] < acc_ratio), ok))
        return out + (ok if skel is None else skel,) if skeleton else out


# ---------------------------------------------------------------------------
# Device-resident membership (sorted-row-fingerprint lookups)
# ---------------------------------------------------------------------------


class TorchJoinMembership:
    """Batched 'is tuple in join J' probes on the device.

    A tuple is in the join iff every base relation contains the tuple's
    projection onto that relation's attributes (the shared output schema
    makes connectivity automatic).  Under §8.3 rejection predicates,
    membership in the *filtered* join is the base membership AND the
    compiled predicate over the tuple's own columns; an unlowerable
    predicate raises ``ValueError``."""

    def __init__(self, spec: JoinSpec, device=None):
        self.device = resolve_device(device)
        self.join_name = spec.name
        self._pred_fn = None
        if spec.reject_preds:
            self._pred_fn = compile_preds_torch(spec.reject_preds,
                                                spec.output_attrs)
        # (attrs, sorted fp1, fp2 in fp1 order, kmax, nrows) per base relation
        self.rels: List[member.Rel] = []
        seen = set()
        for node in spec.nodes:
            rel = node.relation
            attrs = tuple(sorted(rel.attrs))
            # dedup on the host rowset cache key (relation name + attrs)
            if (rel.name, attrs) in seen:
                continue
            seen.add((rel.name, attrs))
            self.rels.append(member.relation_index(
                attrs, [_as_i32(rel.columns[a], f"{rel.name}.{a}")
                        for a in attrs], self.device))
        self.plan = member.MemberPlan([self.rels])

    def pred_mask(self, rows: Rows) -> Optional[torch.Tensor]:
        """The join's compiled rejection predicates over ``rows`` (``None``
        without predicates)."""
        return None if self._pred_fn is None else self._pred_fn(rows)

    def contains(self, rows: Rows,
                 fp_cache: Optional[Dict[Tuple[str, ...], Tuple]] = None
                 ) -> torch.Tensor:
        """Rows are device int32 columns of the output schema.  On the card
        one ``member_lookup`` launch; on the CPU the plain version, where
        one ``fp_cache`` dict passed across the joins probed with the same
        rows fingerprints each attribute set once."""
        return member.contains(self.plan, rows, self.pred_mask(rows),
                               fp_cache)


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


class TorchBackend(Backend):
    """Device-resident engine state: tree joins, membership indexes and
    per-join candidate sources.

    As the reference's ``JaxBackend`` does, a join outside the int32 device
    domain degrades alone: it draws from a host
    :class:`~repro_torch.core.backends.numpy_backend.NumpyCandidateSource`
    (a warning and a ``repro_engine_fallback_total{reason="int32_domain"}``
    event), the other joins stay on the card, and fused rounds turn off for
    the union (``degraded`` names the joins); membership that cannot be
    built on the device probes through the host oracle (``"host_oracle"``).
    Only ``join_method="ew"`` runs on the device: another method records
    ``"join_method"`` and raises.  A missing card, a failed kernel build or
    launch raise; nothing degrades for them."""

    name = "torch"

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec], device=None,
                 seed: int = 0, join_method: str = "ew"):
        if join_method != "ew":
            obs.record_fallback("join_method", detail=join_method)
            raise ValueError("torch backend: only method='ew' runs on the "
                             "device (eo/wj walks stay on the numpy backend)")
        self.device = resolve_device(device)
        self.cat = cat
        self.joins = list(joins)
        self.seed = int(seed)
        schemas = {tuple(sorted(j.output_attrs)) for j in self.joins}
        if len(schemas) > 1:
            raise ValueError(
                f"joins must share an output schema; got {sorted(schemas)}")
        self.attrs = list(self.joins[0].output_attrs)
        self.trees: Dict[str, TorchTreeJoin] = {}
        self.degraded: Dict[str, str] = {}          # join name -> reason
        for j in self.joins:
            try:
                self.trees[j.name] = TorchTreeJoin(cat, j, device=self.device)
            except ValueError as e:
                self.degraded[j.name] = str(e)
                obs.record_fallback("int32_domain", detail=str(e),
                                    join=j.name)
        if self.degraded:
            warnings.warn(
                "torch backend: joins "
                f"{sorted(self.degraded)} fall back to host candidate draws "
                f"({'; '.join(sorted(set(self.degraded.values())))}); fused "
                "device rounds are disabled for this union", stacklevel=2)
        self._members: Optional[Dict[str, TorchJoinMembership]] = None
        self._oracle = None
        self._sources: Dict[str, object] = {}

    @property
    def members(self) -> Dict[str, TorchJoinMembership]:
        if self._members is None:
            self._members = {j.name: TorchJoinMembership(j, device=self.device)
                             for j in self.joins}
        return self._members

    def oracle(self):
        if self._oracle is None:
            try:
                self._oracle = TorchMembershipOracle(self.members, self.attrs,
                                                     self.device)
            except ValueError as e:
                # the draw side's degrade rule: values outside the int32
                # domain keep membership on the (128-bit, exact) host prober
                warnings.warn(
                    f"torch backend: device membership unavailable ({e}); "
                    "probing through the host oracle", stacklevel=2)
                obs.record_fallback("host_oracle", detail=str(e))
                from ..membership import MembershipProber
                self._oracle = MembershipProber(self.cat, self.joins)
        return self._oracle

    def source(self, join_name: str, uniforms=None):
        """The candidate source of one join, built on first use: join ``i``'s
        Philox stream is seeded ``seed + i`` (the reference's seeding);
        ``uniforms`` replaces it.  A degraded join's source is the host's."""
        src = self._sources.get(join_name)
        if src is None:
            i = [j.name for j in self.joins].index(join_name)
            if join_name in self.degraded:
                from .numpy_backend import NumpyCandidateSource
                src = NumpyCandidateSource(self.cat, self.joins[i])
            else:
                src = TorchCandidateSource(self.trees[join_name],
                                           seed=self.seed + i,
                                           uniforms=uniforms)
            self._sources[join_name] = src
        return src

    def supports_fused_rounds(self) -> bool:
        return not self.degraded


class TorchCandidateSource:
    """Candidate source over a :class:`TorchTreeJoin` for the host-driven
    samplers (``OnlineUnionSampler``).

    Device rounds are fixed-width (``device_batch`` draws each); a round's
    accepted rows come to the host in one copy and are served in slices, so
    small requests (the online sampler asks for one row at a time) draw
    from the remainder of the last round.  ``draws`` counts one
    ``device_batch`` per round; §8.2 residual rejections are counted as
    ``walk_ok - accept`` and drained by :meth:`pop_residual_rejects`.  The
    source carries its own uniform stream (``uniforms.tree(streams,
    batch)``)."""

    def __init__(self, tree: TorchTreeJoin, seed: int = 0,
                 device_batch: int = 4096, uniforms=None):
        self.join_name = tree.name
        self.tree = tree
        self.attrs = tree.attrs
        self.uniforms = (uniforms if uniforms is not None
                         else PhiloxUniforms(seed, tree.device))
        self._batch = int(device_batch)
        self._buf: Optional[Dict[str, np.ndarray]] = None
        self._buf_pos = 0
        self._res_rej = 0

    def is_empty(self) -> bool:
        return self.tree.is_empty()

    def pop_residual_rejects(self) -> int:
        """Residual (§8.2 cyclic) rejections since the last pop."""
        n, self._res_rej = self._res_rej, 0
        return n

    def _buffered(self) -> int:
        return 0 if self._buf is None else self._buf[self.attrs[0]].shape[0]

    def _refill(self) -> int:
        """One device round into the buffer; returns rows banked."""
        rows, ok, walk_ok = self.tree.draw(
            self.uniforms.tree(self.tree.n_streams, self._batch))
        mat = torch.stack([rows[a] for a in self.attrs]
                          + [ok.to(torch.int32), walk_ok.to(torch.int32)],
                          dim=1).cpu().numpy()
        ok_h = mat[:, -2].astype(bool)
        if self.tree.has_residual:
            self._res_rej += int(mat[:, -1].sum() - ok_h.sum())
        idx = np.nonzero(ok_h)[0]
        self._buf = {a: mat[idx, i].astype(np.int64)
                     for i, a in enumerate(self.attrs)}
        self._buf_pos = 0
        return int(idx.shape[0])

    def draw(self, rng, count: int, batch: Optional[int] = None
             ) -> Tuple[Dict[str, np.ndarray], int]:
        """``count`` rows and the candidate draws spent on them.  ``rng``
        and ``batch`` are the host protocol's: this source draws from its
        own device stream in rounds of ``device_batch``, as the reference's
        ``JaxCandidateSource`` does."""
        from ..join_sampler import EmptyJoinError
        if self.is_empty():
            raise EmptyJoinError(f"join {self.join_name!r} is empty")
        if self._buf is not None and self._buf_pos + count <= self._buffered():
            lo, hi = self._buf_pos, self._buf_pos + count
            self._buf_pos = hi
            return {a: c[lo:hi] for a, c in self._buf.items()}, 0
        got: List[Dict[str, np.ndarray]] = []
        draws = have = 0
        # the round budget scales with the request (fixed-width rounds)
        max_rounds = 1000 + 20 * (count // self._batch + 1)
        for _ in range(max_rounds):
            if self._buf is None or self._buf_pos >= self._buffered():
                draws += self._batch
                if self._refill() == 0:
                    continue
            lo = self._buf_pos
            hi = min(lo + count - have, self._buffered())
            got.append({a: c[lo:hi] for a, c in self._buf.items()})
            self._buf_pos = hi
            have += hi - lo
            if have >= count:
                break
        else:
            raise RuntimeError(f"TorchCandidateSource({self.join_name}): "
                               "round budget exhausted")
        if len(got) == 1:
            return got[0], draws
        return ({a: np.concatenate([g[a] for g in got]) for a in self.attrs},
                draws)


# ---------------------------------------------------------------------------
# Uniform sources
# ---------------------------------------------------------------------------


class PhiloxUniforms:
    """Production uniform source: one ``torch.Generator`` on the device
    (Philox on CUDA).  A test may pass any object with the same methods,
    e.g. one that replays the reference's JAX key schedule.

    :meth:`mark` and :meth:`rewind` let the device round loop
    (``fused_rounds="device"``) take back the uniforms that its gated
    rounds drew at the end of a call: on CUDA by moving the Philox offset
    (one round advances it by a fixed increment, measured once per round
    shape), on the CPU by restoring the generator's state and drawing the
    kept rounds again."""

    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))
        self._round_inc: Dict[Tuple, int] = {}

    def round(self, slot: int, shapes: Sequence[Tuple[int, int]]
              ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """Cover-selection uniforms ``(slot,)`` plus one ``(streams, batch)``
        block per join, cut from a single generator call."""
        sizes = [slot] + [s * b for s, b in shapes]
        flat = torch.rand(sum(sizes), generator=self.generator,
                          device=self.device)
        parts = torch.split(flat, sizes)
        return parts[0], [p.view(s, b) for p, (s, b) in zip(parts[1:], shapes)]

    def mark(self):
        """The stream's position, for :meth:`rewind`."""
        if self.device.type == "cuda":
            return self.generator.get_offset()
        return self.generator.get_state()

    def rewind(self, mark, rounds: int, slot: int,
               shapes: Sequence[Tuple[int, int]]) -> None:
        """Put the stream where ``rounds`` calls of ``round(slot, shapes)``
        starting at ``mark`` leave it."""
        if self.device.type != "cuda":
            self.generator.set_state(mark)
            for _ in range(rounds):
                self.round(slot, shapes)
            return
        key = (int(slot), tuple(shapes))
        inc = self._round_inc.get(key)
        if inc is None and rounds:
            self.generator.set_offset(mark)
            self.round(slot, shapes)
            inc = self._round_inc[key] = self.generator.get_offset() - mark
        self.generator.set_offset(mark + rounds * (inc or 0))

    def permutation(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator, device=self.device)

    def tree(self, streams: int, batch: int) -> torch.Tensor:
        """``(streams, batch)`` uniforms of one candidate-source round."""
        return torch.rand((streams, batch), generator=self.generator,
                          device=self.device)

    def walk(self, n_root: int, n_hops: int, batch: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One wander-join batch: root positions ``(batch,)`` int64 in
        ``[0, max(n_root, 1))`` and ``(n_hops, batch)`` hop uniforms."""
        r_pos = torch.randint(0, max(int(n_root), 1), (batch,),
                              generator=self.generator, device=self.device)
        return r_pos, torch.rand((n_hops, batch), generator=self.generator,
                                 device=self.device)


# ---------------------------------------------------------------------------
# Algorithm-1 rounds (static or adaptive plan, probe membership)
# ---------------------------------------------------------------------------


# SamplerStats fields the engine accumulates as one device vector
_STAT_FIELDS = ("iterations", "candidate_draws", "cover_rejects",
                "residual_rejects", "pred_rejects", "dropped_slots",
                "residual_misses", "member_lookups")

# Per-piece round counters, one (nj, 5) device matrix per sample() call:
# candidate draws, cover-accepted rows, §8.2 residual rejections, rows
# drained from the surplus bank, and the post-round bank high-water mark.
PIECE_STAT_FIELDS = ("draws", "accepts", "residual_rejects",
                     "bank_drained", "bank_hwm")

# Layout of a capacity class's per-call counter vector (int64): the target
# n, rows emitted, rounds run, the unreachable-cover flag, then the
# _STAT_FIELDS and the (nj, 5) per-piece counters
_CTR_N, _CTR_TOTAL, _CTR_ROUNDS, _CTR_FAIL, _CTR_STATS = range(5)

# gated rounds run on a side stream before a capture (PyTorch's CUDA-graph
# warm-up): they build whatever the round builds on first use
_CAPTURE_WARMUP_ROUNDS = 2
# one capture at a time in the process (CUDA's rule): samplers in several
# producer threads (replicas in one SampleService) capture in turn
_CAPTURE_LOCK = threading.Lock()


def _cover_cum(probs_base: torch.Tensor, dead: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dead-masked, renormalised selection CDF + unreachable flag."""
    p = torch.where(dead, torch.zeros_like(probs_base), probs_base)
    s = p.sum()
    return torch.cumsum(p, 0) / torch.clamp(s, min=1e-30), s <= 0


def _piece_batches(probs, round_batch: int, balance: str,
                   slack: float) -> Tuple[int, ...]:
    """Static per-join candidate widths for one round.

    ``balance="cover"`` sizes each join's draw batch proportionally to its
    cover selection probability (head-room ``slack``, floor 256, rounded to
    multiples of 128 to bound shape variety) instead of drawing
    ``round_batch`` candidates from *every* join — a piece with 5 %
    selection mass can never emit more than ~5 % of the round's slots.
    Undershoot is harmless: the shortfall carry tops the piece up next
    round.  ``balance="full"`` keeps the uniform-width behaviour."""
    nj = len(probs)
    if balance != "cover":
        return (int(round_batch),) * nj
    p = np.maximum(np.asarray(probs, np.float64), 0)
    s = p.sum()
    if s <= 0:
        return (int(round_batch),) * nj
    out = []
    for j in range(nj):
        want = int(np.ceil(slack * (p[j] / s) * round_batch))
        b = max(256, ((want + 127) // 128) * 128)
        out.append(min(int(round_batch), b))
    return tuple(out)


def _emit_and_bank(out, pos, bank, head, count, cols, dt, ft, acc,
                   cap: int, trash: int, W: int, bank_base=None,
                   fresh_base=None):
    """Scatter one round's emission into ``out`` and roll the banks.

    Rows travel as ``(rows, A+1)`` int32 matrices (last column = home
    piece).  ``out`` has a trash row at index ``trash`` and ``bank`` is
    ``(nj, cap + 1, A+1)`` with a trash slot at ``cap``: masked scatters go
    there instead of being dropped, and so do rows past the end of ``out``
    (the reference's ``mode="drop"``).  Emission order: pieces in cover
    order; per piece the ``dt`` banked rows (FIFO, oldest first) then the
    ``ft`` fresh rows.  Surplus accepts are pushed at the ring tail.
    ``out`` and ``bank`` are updated in place; the banked rows are gathered
    before any push.  ``bank_base``/``fresh_base`` override the per-piece
    output offsets of the banked and fresh rows: the sharded loop passes
    global offsets, so each rank scatters its rows straight to their final
    positions (by default this call's take is packed at ``pos``)."""
    nj = dt.shape[0]
    dev = dt.device
    take = dt + ft
    if bank_base is None:
        bank_base = pos + torch.cumsum(take, 0) - take   # exclusive prefix
        fresh_base = bank_base + dt
    r = torch.arange(W, device=dev)
    bmask = r[None, :] < dt[:, None]
    bidx = (head[:, None] + r[None, :]) % cap
    bdst = torch.clamp(torch.where(bmask, bank_base[:, None] + r[None, :],
                                   trash),
                       max=trash).reshape(-1)
    jrow = torch.arange(nj, device=dev)[:, None]
    bvals = bank[jrow, bidx]                          # (nj, W, A+1) copy
    out[bdst] = bvals.reshape(nj * W, -1)
    push = torch.minimum(acc - ft, cap - (count - dt))
    for j in range(nj):
        cj = cols[j]
        rj = torch.arange(cj.shape[0], device=dev)
        fdst = torch.clamp(torch.where(rj < ft[j], fresh_base[j] + rj, trash),
                           max=trash)
        pidx = torch.where((rj >= ft[j]) & (rj < ft[j] + push[j]),
                           (head[j] + count[j] + rj - ft[j]) % cap, cap)
        out[fdst] = cj
        bank[j][pidx] = cj
    head = (head + dt) % cap
    count = count - dt + push
    return pos + take.sum(), head, count


@dataclasses.dataclass
class _LoopState:
    """Device carry that persists across sample() calls.  Its tensors are
    static: every round updates them in place (a captured round holds their
    addresses)."""

    owed: torch.Tensor      # (nj,) int64 per-piece carried shortfall
    dead: torch.Tensor      # (nj,) bool
    streak: torch.Tensor    # (nj,) int64 rounds without yield
    bank: torch.Tensor      # (nj, cap + 1, A+1) int32 ring banks (+ trash)
    head: torch.Tensor      # (nj,) int64
    count: torch.Tensor     # (nj,) int64
    ema: Optional[torch.Tensor] = None  # (nj, 4) int32, plan="adaptive" only
    # (nj,) int64 bank occupancy over all ranks at round start: the sharded
    # device loop's budget input under plan="adaptive" (its banks are per rank)
    gcount: Optional[torch.Tensor] = None


def capacity_class(n: int) -> int:
    """The output-capacity class ``C`` of a request of ``n`` rows: the next
    power of two, floored at 1024.  The device loop keeps one
    :class:`_CallBuffers` (and on the card one captured round) per class."""
    return 1 << max(10, (int(n) - 1).bit_length())


class _CallBuffers:
    """The static per-call buffers of one capacity class ``C``.

    ``ctr`` is one int64 vector (layout ``_CTR_*``) whose views are the
    target ``n``, ``total``, ``rounds``, ``fail``, the stats vector and the
    per-piece matrix, so a call resets them in one op and a chunk's sync
    reads ``(total, rounds, fail)`` in one copy; ``out`` is ``(C + 1,
    A+1)`` with the trash row at ``C``.  In device mode on the card the
    class also holds its CUDA graph of one round, the kernel launches one
    replay makes and the capture's wall seconds; on the card, a pair of
    timing events that bound a chunk's replays while the spans are on."""

    def __init__(self, C: int, nj: int, width: int, device):
        self.C = C
        s = _CTR_STATS + len(_STAT_FIELDS)
        self.ctr = torch.zeros(s + nj * len(PIECE_STAT_FIELDS),
                               dtype=torch.int64, device=device)
        self.n, self.total, self.rounds, self.fail = (
            self.ctr[i] for i in (_CTR_N, _CTR_TOTAL, _CTR_ROUNDS, _CTR_FAIL))
        self.stats = self.ctr[_CTR_STATS:s]
        self.pstats = self.ctr[s:].view(nj, len(PIECE_STAT_FIELDS))
        self.out = torch.zeros((C + 1, width), dtype=torch.int32,
                               device=device)
        self.graph = None
        self.replay_launches: Dict[str, int] = {}
        self.capture_s = 0.0
        self.last_rounds = 0        # the previous call's rounds (chunk size)
        self.events = ((torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                       if torch.device(device).type == "cuda" else None)


class _ReadySample:
    """Degenerate handle: the sample already exists."""

    def __init__(self, ss):
        self._ss = ss

    def result(self):
        return self._ss


class _PendingSample:
    """One call of the round loop, from its launch to its drain.

    ``sample_async`` launches the call: it enqueues the first chunk of
    rounds and returns.  The call is finished by the next ``sample_async``
    of its engine or by ``result()``, whichever comes first: the chunk
    syncs and any further chunks, the rewind of the gated rounds'
    uniforms, the pack of the shuffled rows and the call's counters into
    one int64 tensor (the next call reuses the class's static buffers), and
    that tensor's copy to the host, started without a sync.  ``result()``
    drains it: it waits on the copy (the call's one fetch sync), folds the
    counters and builds the SampleSet, on the host while the card runs a
    later call's chunk.  The call's own chunks, host syncs and gated rounds
    are counted here and reach the engine's ``last_*`` attributes at the
    drain."""

    def __init__(self, sampler, n: int, cb: _CallBuffers):
        self._sampler = sampler
        self._n = int(n)
        self.cb = cb
        self.rounds = self.chunks = self.host_syncs = self.wasted_rounds = 0
        self.total = self.fail = 0
        self.chunk_k = 0        # rounds in the chunk in flight
        self.mark = None        # the uniform stream's position before it
        self.timed = False      # its replays bounded by the class's events
        self._host = self._copied = None
        self._done = None

    def start_copy(self, fetch: torch.Tensor) -> None:
        """Start the copy of the packed ``fetch`` to the host: on the card
        into pinned memory from the caching host allocator, with an event
        after it (``fetch`` itself may go: the stream orders any reuse of
        its memory after the copy); on the CPU it is ``fetch`` itself."""
        self._host = fetch
        if fetch.device.type == "cuda":
            self._host = torch.empty(fetch.shape, dtype=fetch.dtype,
                                     pin_memory=True)
            self._host.copy_(fetch, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()

    def result(self):
        if self._done is not None:
            return self._done
        with obs.span("loop.result"), self._sampler._on_device():
            return self._result()

    def _result(self):
        s = self._sampler
        t0 = time.perf_counter() if obs.enabled() else 0.0
        if self._host is None:          # the engine's call in flight
            s._finish(self)
        if s._inflight is not None:     # a later call's chunk is queued
            s.overlapped_drains += 1
            if obs.enabled():
                s._obs_handles()["overlapped"].inc()
        # rounds, like every counter, are folded at the drain (a launched
        # call that is never drained adds nothing)
        s.last_rounds, s.last_chunks = self.rounds, self.chunks
        s.last_host_syncs = self.host_syncs
        s.last_wasted_rounds = self.wasted_rounds
        s.total_rounds += self.rounds
        s.wasted_rounds += self.wasted_rounds
        if self.fail:
            raise RuntimeError("all cover pieces unreachable")
        if self.total < self._n:
            raise RuntimeError("TorchUnionSampler: top-up budget exhausted")
        from ..relation import fingerprint128
        from ..union_sampler import SampleSet
        with obs.span("loop.fetch"):
            if self._copied is not None:
                self._copied.synchronize()
            flat = self._host.numpy()
        self.host_syncs += 1
        s.last_host_syncs += 1
        s.host_syncs += 1
        nj, width = len(s.order), len(s.attrs) + 1
        k = self._n * width
        mat = flat[:k].reshape(self._n, width)
        counters = flat[k:]
        ns, npc = len(_STAT_FIELDS), nj * len(PIECE_STAT_FIELDS)
        with obs.span("loop.fold"):
            for f, v in zip(_STAT_FIELDS, counters[:ns]):
                setattr(s.stats, f, getattr(s.stats, f) + int(v))
            ema = (counters[ns + npc:].reshape(nj, -1)
                   if s.plan == "adaptive" else None)
            s._fold_piece_stats(counters[ns:ns + npc].reshape(nj, -1),
                                rounds=self.rounds, samples=self._n, ema=ema)
        with obs.span("loop.fingerprint"):
            # copies: no column may alias the host buffer, which the
            # caching allocator hands to a later call
            rows = {a: mat[:, i].copy() for i, a in enumerate(s.attrs)}
            home = mat[:, -1].copy()
            fp = fingerprint128([rows[a] for a in sorted(s.attrs)])
            self._done = SampleSet(list(s.attrs), rows, home, fp, s.stats)
        self._host = self._copied = None
        if obs.enabled():
            s._obs_handles()["drain"].observe(time.perf_counter() - t0)
        return self._done


class TorchUnionSampler:
    """The multi-round Algorithm-1 loop with its state on the device.

    Per round (``piece_batches[j]`` candidates for join j):

    1. **multinomial cover selection** — per-slot categorical on the piece
       probabilities, histogrammed into per-piece targets and added to the
       shortfall carried from earlier rounds,
    2. **candidate generation for all joins** — one batched EW tree draw per
       join (cyclic pieces verify their residual edges in the same draw),
    3. **§8.3 predicate acceptance** — the piece's ``reject_preds`` and the
       union-wide ``predicate``, compiled to one mask per piece,
    4. **cover-membership acceptance** — a candidate of piece ``j`` survives
       iff no earlier cover piece contains it,
    5. **compaction and banking** — accepted rows ranked to the front per
       join (a cumsum scatter); each per-piece target is served first from
       that piece's FIFO surplus bank, then from the fresh accepts, and
       leftover accepts are pushed back into the bank.

    The shortfall of piece ``j`` stays assigned to piece ``j`` across
    rounds (never re-drawn from the selection distribution), and the banks
    are FIFOs over i.i.d. streams, so the output is uniform over the union.

    The round is one step over static buffers with no host sync
    (:meth:`_round_step`), gated off once the call is done.
    ``fused_rounds="device"`` (default) captures it per capacity class as a
    CUDA graph and replays it ``K`` rounds at a time, with one host sync per
    chunk on ``(total, rounds, fail)`` — the reference's one-program
    ``lax.while_loop`` cut into chunks; the uniforms of the gated rounds of
    the last chunk are rewound, so the stream continues where the host
    loop's would.  ``fused_rounds="host"`` runs the same step with a sync
    after every round (the reference's debugging twin).  Both give the same
    samples, homes, stats and carry from the same seed.  On the CPU the
    device mode runs the step eagerly in the same chunks.

    A device-loop call has three phases (:class:`_PendingSample`):
    ``sample_async`` launches it (its first chunk enqueued, no host sync),
    the next ``sample_async`` or the handle's ``result()`` finishes it (the
    chunk syncs, the rewind, the pack and the start of the copy to the
    host, all before any later call's rounds), and ``result()`` drains it
    (the wait on the copy, the counter fold and the fingerprints).  So a
    caller that launches call *k+1* before draining call *k* has the host
    drain *k* while the card runs *k+1*'s chunk (``overlapped_drains``
    counts such drains); the samples, stats and carry are those of calls
    made one after the other.

    ``plan="adaptive"`` widens the selection slot (``adaptive_slot``), sizes
    the draw widths from the seeded acceptance rates (``alloc_batches``) and
    carries per-piece acceptance EMAs on the device; each round a piece
    draws only a count-derived prefix of its i.i.d. slots (``budget_for``),
    and the EMAs take one step from the round's counts (``ema_update``).

    ``chunk_rounds`` (attribute, default ``None``) forces ``K``; by default
    ``K`` is the previous call's round count in the class (1 at first), and
    a further chunk of the same call is sized by the rows still owed at the
    call's yield per round.
    """

    def __init__(self, backend: TorchBackend, cover, seed: int = 0,
                 round_batch: int = 4096, dead_rounds: int = 8,
                 max_rounds: int = 4096, surplus_cap: Optional[int] = None,
                 stats=None, fused_rounds: str = "device",
                 balance: str = "cover", balance_slack: float = 1.5,
                 uniforms=None, predicate=None, plan: str = "static"):
        if fused_rounds not in ("device", "host"):
            raise ValueError("fused_rounds must be 'device' or 'host', got "
                             f"{fused_rounds!r}")
        self.fused_rounds = fused_rounds
        self.backend = backend
        self.device = backend.device
        self.cover = cover
        self.order = list(cover.order)
        self.trees = [backend.trees[n] for n in self.order]
        self.attrs = tuple(backend.attrs)
        self.uniforms = (uniforms if uniforms is not None
                         else PhiloxUniforms(seed, self.device))
        self.round_batch = int(round_batch)
        self.dead_rounds = int(dead_rounds)
        self.max_rounds = int(max_rounds)
        self.surplus_cap = max(1, 8 * self.round_batch if surplus_cap is None
                               else int(surplus_cap))
        if stats is None:
            from ..union_sampler import SamplerStats
            stats = SamplerStats()
        self.stats = stats
        # §8.3 predicate acceptance per cover piece (None = none): its own
        # reject_preds AND the union-wide predicate, applied between the
        # draw and the earlier-piece probes
        self.predicate = predicate
        gp = tuple(predicate.preds) if predicate is not None else ()
        self._pred_fns = []
        for tree in self.trees:
            own = tuple(tree.spec.reject_preds) + gp
            self._pred_fns.append(
                compile_preds_torch(own, tree.spec.output_attrs) if own
                else None)
        base = np.maximum(np.asarray(cover.selection_probs(), np.float64), 0)
        s = base.sum()
        self._probs_base = torch.as_tensor(
            (base / s if s > 0 else base).astype(np.float32), device=self.device)
        self.piece_batches = _piece_batches(base, self.round_batch, balance,
                                            balance_slack)
        if plan not in ("static", "adaptive"):
            raise ValueError(f"plan must be 'static' or 'adaptive', got "
                             f"{plan!r}")
        self.plan = plan
        self._slot_width = self.round_batch
        self._ema_seed = None
        if plan == "adaptive":
            self._ema_seed = planner.seed_rates(
                cover, {t.name: t.spec for t in self.trees})
            self._slot_width = planner.adaptive_slot(self.round_batch)
            self.piece_batches = planner.alloc_batches(
                self.piece_batches, base, self._ema_seed[:, 0],
                self._slot_width)
        self._set_piece_batches(self.piece_batches)
        self._plan_cache_key = planner.plan_key(backend.cat, backend.joins,
                                                cover)
        # per-piece bank drain cap per round (a semantics constant shared
        # with the reference: dt = min(need, count, W))
        self._drain_w = min(self.round_batch, 256)
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._zero = torch.zeros((), dtype=torch.int64, device=self.device)
        self.piece_stats = np.zeros((len(self.order), len(PIECE_STAT_FIELDS)),
                                    np.int64)
        self.last_rounds = 0
        self.total_rounds = 0
        self.last_host_syncs = 0
        self.host_syncs = 0
        # per call: chunks of rounds between syncs (host mode: one per
        # round) and gated rounds replayed (device mode); a call makes
        # last_chunks + 1 host syncs (the chunks' syncs and the one fetch)
        self.last_chunks = 0
        self.last_wasted_rounds = 0
        self.wasted_rounds = 0
        self.chunk_rounds: Optional[int] = None
        self.capture_seconds: Dict[int, float] = {}
        # device seconds of the chunks' replays, from CUDA events (on the
        # card, while the spans are on)
        self.graph_device_seconds = 0.0
        # drains that ran while a later call's chunk was in flight
        self.overlapped_drains = 0
        self._inflight: Optional[_PendingSample] = None   # launched, unfinished
        self._state: Optional[_LoopState] = None
        self._buffers: Dict[int, _CallBuffers] = {}
        self._graph_pool = None
        self._obs_metrics = None
        self._member_plans: Dict[int, member.MemberPlan] = {}

    def _set_piece_batches(self, piece_batches) -> None:
        """Set the per-join draw widths and the device constants derived
        from them (the sharded engine calls it again after scaling the
        widths to ``world`` ranks)."""
        self.piece_batches = tuple(int(b) for b in piece_batches)
        self._pbatch = torch.as_tensor(self.piece_batches, dtype=torch.int64,
                                       device=self.device)
        self._pbatch_i32 = self._pbatch.to(torch.int32)
        self._ema_shifts = (torch.as_tensor(
            planner.ema_shifts(self.piece_batches), device=self.device)
            if self.plan == "adaptive" else None)

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

    def _pred_mask(self, j: int, rows: Rows, acc: torch.Tensor):
        """Piece ``j``'s §8.3 acceptance: ``(acc & pred, rejected count)``."""
        pf = self._pred_fns[j]
        if pf is None:
            return acc, torch.zeros((), dtype=torch.int64, device=acc.device)
        pok = pf(rows)
        return acc & pok, (acc & ~pok).sum()

    def _round_shapes(self) -> List[Tuple[int, int]]:
        """The ``(streams, batch)`` uniform blocks of one round."""
        return [(t.n_streams, b) for t, b in zip(self.trees, self.piece_batches)]

    # -- one round -------------------------------------------------------------
    def _round_core(self, probs_cum: torch.Tensor, owed: torch.Tensor,
                    extra: torch.Tensor, ema: Optional[torch.Tensor] = None,
                    bank_count: Optional[torch.Tensor] = None):
        """Selection + draws + predicates + earlier-piece rejection +
        compaction.

        Returns per join the accepted-compacted ``(B_j, A+1)`` matrices plus
        the (walk_ok, residual, accepted, predicate-reject) counts, the
        per-piece need = carry + this round's targets, (adaptive plan, else
        None) the per-piece candidate budget, the round's residual misses
        and its member lookups (live candidates times earlier pieces)."""
        nj = len(self.trees)
        dev = self.device
        members = [self.backend.members[n] for n in self.order]
        u_sel, u_joins = self.uniforms.round(self._slot_width,
                                             self._round_shapes())
        pick = torch.clamp(torch.searchsorted(probs_cum, u_sel, side="right"),
                           0, nj - 1)
        valid = (torch.arange(self._slot_width, device=dev) < extra).to(torch.int64)
        need = owed + torch.zeros(nj, dtype=torch.int64,
                                  device=dev).scatter_add_(0, pick, valid)
        budget = None
        if ema is not None:
            # integer budget from counts only (owed work minus usable bank
            # coverage over the accept EMA), in the reference's int32
            budget = planner.budget_for(
                need.to(torch.int32), bank_count.to(torch.int32), ema[:, 0],
                self._pbatch_i32, self._drain_w, planner.TORCH_XP)
        cols, okc, resc, accc, predc, missc = [], [], [], [], [], []
        lookc = []
        for j, tree in enumerate(self.trees):
            bj = self.piece_batches[j]
            rows, acc, walk_ok, *skel = tree.draw(u_joins[j],
                                                  skeleton=tree.has_residual)
            if budget is not None:
                # the first budget[j] slots of an i.i.d. candidate stream: a
                # count-derived prefix, so the survivors stay i.i.d. uniform
                elig = torch.arange(bj, device=dev) < budget[j]
                acc = acc & elig
                walk_ok = walk_ok & elig
                skel = [s & elig for s in skel]
            resc.append(walk_ok.sum() - acc.sum())
            missc += [s.sum() - walk_ok.sum() for s in skel]
            acc, pr = self._pred_mask(j, rows, acc)
            predc.append(pr)
            if j:                          # pieces earlier in cover order
                acc, looked = member.member_lookup(
                    self._member_plan(j), rows, acc,
                    [members[q].pred_mask(rows) for q in range(j)])
                lookc.append(looked)
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
        misses = torch.stack(missc).sum() if missc else self._zero
        lookups = torch.stack(lookc).sum() if lookc else self._zero
        return (cols, torch.stack(okc), torch.stack(resc), torch.stack(accc),
                torch.stack(predc), need, budget, misses, lookups)

    def _member_plan(self, j: int) -> member.MemberPlan:
        """The earlier pieces that join ``j``'s candidates are looked up in
        (built at the first round)."""
        plan = self._member_plans.get(j)
        if plan is None:
            members = self.backend.members
            plan = self._member_plans[j] = member.MemberPlan(
                [members[n].rels for n in self.order[:j]])
        return plan

    def _round_step(self, cb: _CallBuffers) -> None:
        """One Algorithm-1 round on the static buffers, with no host sync.

        Every write is gated by ``active = (total < n) & (rounds <
        max_rounds) & ~fail``, computed at the start.  An inactive round
        still draws (the device loop rewinds its uniforms), but its targets
        are 0, so every scatter goes to a trash row, and the small state
        keeps its value through ``torch.where``; the banks and the output
        are never copied.  The host loop never runs an inactive round."""
        st = self._state
        cap = self.surplus_cap
        adaptive = self.plan == "adaptive"
        zero = self._zero
        active = (cb.total < cb.n) & (cb.rounds < self.max_rounds) & (cb.fail == 0)
        probs_cum, bad = _cover_cum(self._probs_base, st.dead)
        extra = torch.where(active, torch.clamp(
            cb.n - cb.total - st.owed.sum(), 0, self._slot_width), zero)
        (cols, okc, resc, accc, predc, need, budget, misses,
         lookups) = self._round_core(probs_cum, st.owed, extra, st.ema,
                                     st.count)
        # `extra` is 0 once total >= n, but the carried `owed` is not
        need = torch.where(active, need, zero)
        acc = torch.where(active, accc, zero)
        # bank take (FIFO, capped) → fresh take → carried shortfall
        dt = torch.clamp(torch.minimum(need, st.count), max=self._drain_w)
        ft = torch.minimum(need - dt, acc)
        total, head, count = _emit_and_bank(
            cb.out, cb.total, st.bank, st.head, st.count, cols, dt, ft, acc,
            cap, cb.C, min(self._drain_w, cap))
        shortfall = need - dt - ft
        # dead-piece bookkeeping: stray picks on dead pieces are dropped;
        # a live piece that keeps a target but yields nothing for
        # dead_rounds rounds is empty in reality — drop it
        dropped = torch.where(st.dead, shortfall, zero).sum()
        shortfall = torch.where(st.dead, zero, shortfall)
        trig = (shortfall > 0) & (acc == 0) & (count == 0)
        streak = torch.where(st.dead, st.streak,
                             torch.where(trig, st.streak + 1, zero))
        newly = ~st.dead & (streak >= self.dead_rounds) & active
        dropped = dropped + torch.where(newly, shortfall, zero).sum()
        shortfall = torch.where(newly, zero, shortfall)
        # adaptive rounds draw only the budgeted slots; static rounds
        # spend the full width every round
        drawn = budget.sum() if adaptive else zero + int(sum(self.piece_batches))
        cb.stats.add_(torch.where(active, torch.stack([
            drawn, drawn,
            okc.sum() - resc.sum() - predc.sum() - accc.sum(), resc.sum(),
            predc.sum(), dropped, misses, lookups]), zero))
        ps = cb.pstats
        cb.pstats.copy_(torch.where(active, torch.stack([
            ps[:, 0] + (budget if adaptive else self._pbatch),
            ps[:, 1] + accc, ps[:, 2] + resc, ps[:, 3] + dt,
            torch.maximum(ps[:, 4], count)], dim=1), ps))
        if adaptive:
            # one EMA step from this round's counts per budgeted slot
            counts4 = torch.stack([accc, okc, resc, predc],
                                  dim=1).to(torch.int32)
            st.ema.copy_(torch.where(active, planner.ema_update(
                st.ema, budget, counts4, self._ema_shifts, planner.TORCH_XP),
                st.ema))
        st.owed.copy_(torch.where(active, shortfall, st.owed))
        st.dead.logical_or_(newly)
        st.streak.copy_(torch.where(active, streak, st.streak))
        st.head.copy_(head)
        st.count.copy_(count)
        cb.total.copy_(total)
        cb.fail.logical_or_(bad & active)
        cb.rounds.add_(active.to(torch.int64))

    # -- the loop --------------------------------------------------------------
    def _bank_cap(self) -> int:
        """Ring capacity of one piece's surplus bank."""
        return self.surplus_cap

    def _init_state(self) -> _LoopState:
        nj, cap, dev = len(self.order), self._bank_cap(), self.device
        z = lambda: torch.zeros(nj, dtype=torch.int64, device=dev)  # noqa: E731
        return _LoopState(
            owed=z(), dead=torch.zeros(nj, dtype=torch.bool, device=dev),
            streak=z(),
            bank=torch.zeros((nj, cap + 1, len(self.attrs) + 1),
                             dtype=torch.int32, device=dev),
            head=z(), count=z(),
            ema=(torch.as_tensor(self._ema_seed, device=dev)
                 if self.plan == "adaptive" else None))

    def _call_buffers(self, C: int) -> _CallBuffers:
        """The static buffers of capacity class ``C``."""
        cb = self._buffers.get(C)
        if cb is None:
            cb = self._buffers[C] = _CallBuffers(
                C, len(self.order), len(self.attrs) + 1, self.device)
        return cb

    def sample_async(self, n: int):
        """Launch the round loop for ``sample(n)`` and return its handle.

        The call in flight, if any, is finished first (its syncs, rewind,
        pack and copy come before this call's rounds).  The device loop
        then enqueues this call's first chunk and returns with no host
        sync, so the caller can drain the earlier call while the card runs
        this one (the serve tier dispatches call *k+1* before draining
        call *k*).  Where :meth:`_defers_finish` is false the call is
        finished here.  ``result()`` finishes the call if nothing has yet
        and does the one device→host fetch."""
        from ..union_sampler import empty_sample_set
        if n <= 0:
            return _ReadySample(empty_sample_set(list(self.attrs), self.stats))
        t0 = time.perf_counter() if obs.enabled() else 0.0
        with self._on_device(), obs.span("loop.dispatch"):
            if self._inflight is not None:
                self._finish(self._inflight)
            call = self._launch(int(n))
            if not self._defers_finish():
                self._finish(call)
        if obs.enabled():
            self._obs_handles()["dispatch"].observe(time.perf_counter() - t0)
        return call

    def _defers_finish(self) -> bool:
        """Whether ``sample_async`` returns with the call's first chunk in
        flight (the device loop) or finishes the call itself (the host
        loop, which syncs after every round)."""
        return self.fused_rounds == "device"

    def _launch(self, n: int) -> _PendingSample:
        """Reset the class's buffers for a call of ``n`` rows and, in the
        device loop, enqueue its first chunk of ``K`` rounds: the class's
        previous call's round count (1 at first), or ``chunk_rounds``."""
        if self._state is None:
            self._state = self._init_state()
        cb = self._call_buffers(capacity_class(n))
        device_loop = self.fused_rounds == "device"
        if device_loop and self._graphs() and cb.graph is None:
            self._capture(cb)
        self._reset(cb, n)
        call = _PendingSample(self, n, cb)
        if device_loop:
            self._chunk(call, self.chunk_rounds or max(cb.last_rounds, 1))
        self._inflight = call
        return call

    def _finish(self, call: _PendingSample) -> None:
        """Run ``call``'s loop to its end, pack its rows and counters and
        start their copy to the host."""
        self._inflight = None
        cb, n = call.cb, call._n
        with obs.span("loop.finish"):
            if self.fused_rounds == "device":
                self._loop_device(call)
            else:
                self._loop_host(call)
            cb.last_rounds = call.rounds
            # the call's rows, shuffled, and its counters (the adaptive EMAs
            # too) leave the static buffers in one tensor: the one fetch
            with obs.span("loop.pack"):
                shuffle = self.uniforms.permutation(n)
                parts = [self._call_rows(cb, n)[shuffle].reshape(-1)
                         .to(torch.int64), cb.ctr[_CTR_STATS:]]
                if self.plan == "adaptive":
                    parts.append(self._state.ema.reshape(-1).to(torch.int64))
                fetch = torch.cat(parts)
            call.start_copy(fetch)

    def _graphs(self) -> bool:
        """Whether the device loop replays a captured CUDA graph (on the
        card) or runs its step eagerly (on the CPU)."""
        return self.device.type == "cuda"

    def _reset(self, cb: _CallBuffers, n: int) -> None:
        """Zero the class's counters and set the call's target ``n``."""
        cb.ctr.zero_()
        cb.n.fill_(n)

    def _call_rows(self, cb: _CallBuffers, n: int) -> torch.Tensor:
        """The call's ``n`` rows in emission order."""
        return cb.out[:n]

    def _mark_uniforms(self):
        return self.uniforms.mark()

    def _rewind_uniforms(self, mark, rounds: int) -> None:
        """Put the round stream where ``rounds`` rounds from ``mark`` leave
        it (the device loop's gated rounds drew past that)."""
        self.uniforms.rewind(mark, rounds, self._slot_width,
                             self._round_shapes())

    def _sync(self, call: _PendingSample) -> Tuple[int, int, int]:
        """The loop's one host sync: ``(total, rounds, fail)``."""
        with obs.span("loop.chunk_sync"):
            total, rounds, fail = call.cb.ctr[_CTR_TOTAL:_CTR_STATS].tolist()
        call.chunks += 1
        call.host_syncs += 1
        self.host_syncs += 1
        call.total, call.fail = total, fail
        return total, rounds, fail

    def _done(self, n: int, total: int, rounds: int, fail: int) -> bool:
        return bool(fail) or total >= n or rounds >= self.max_rounds

    def _loop_host(self, call: _PendingSample) -> None:
        """``fused_rounds="host"``: one round, then one sync, until done."""
        while True:
            self._round_step(call.cb)
            total, call.rounds, fail = self._sync(call)
            if self._done(call._n, total, call.rounds, fail):
                return

    def _chunk(self, call: _PendingSample, K: int) -> None:
        """Enqueue ``K`` rounds of ``call`` (at most the rounds it has
        left), after marking the uniform stream for the rewind.  While the
        spans are on, two CUDA events on the card bound the replays; their
        elapsed time, read after the chunk's sync, adds to
        ``graph_device_seconds``."""
        cb = call.cb
        call.chunk_k = K = max(1, min(K, self.max_rounds - call.rounds))
        call.mark = self._mark_uniforms()
        call.timed = (cb.events is not None
                      and obs.trace_annotations_enabled())
        if call.timed:
            cb.events[0].record()
        self._replay(cb, K)
        if call.timed:
            cb.events[1].record()

    def _loop_device(self, call: _PendingSample) -> None:
        """``fused_rounds="device"``: the chunks of rounds from the one in
        flight on, one sync per chunk; the uniforms that the gated rounds
        of the last chunk drew are rewound.  A further chunk is sized by
        the rows still owed at the call's yield per round."""
        cb, n = call.cb, call._n
        while True:
            total, rounds, fail = self._sync(call)
            if call.timed:              # both events are done at the sync
                self.graph_device_seconds += (
                    cb.events[0].elapsed_time(cb.events[1]) / 1e3)
            ran = rounds - call.rounds
            if ran < call.chunk_k:      # gated rounds only once it is done
                self._rewind_uniforms(call.mark, ran)
                call.wasted_rounds += call.chunk_k - ran
            call.rounds = rounds
            if self._done(n, total, rounds, fail):
                return
            # (at most as many rounds as have run: a slow start doubles)
            self._chunk(call, self.chunk_rounds or min(
                max(1, -(-rounds * (n - total) // max(total, 1))), rounds))

    def _replay(self, cb: _CallBuffers, K: int) -> None:
        """``K`` rounds: graph replays on the card (each adds the kernel
        launches captured in one round to the shared counts), the step
        itself on the CPU."""
        with obs.span("loop.replay"):
            if cb.graph is None:
                for _ in range(K):
                    self._round_step(cb)
                return
            for _ in range(K):
                cb.graph.replay()
        for k, v in cb.replay_launches.items():
            build.launch_counts[k] += v * K

    def _capture(self, cb: _CallBuffers) -> None:
        """Capture one round of class ``cb.C`` as a CUDA graph.

        First a few gated rounds (``n = 0``) on a side stream, as PyTorch's
        CUDA-graph notes require: they build what the round builds on first
        use (membership indexes, predicate sets, the kernel library) and
        change no carry.  The sampler's Philox generator is registered with
        the graph, every graph of the sampler shares one memory pool, and the
        stream is rewound to where it stood.  A capture that fails raises:
        there is no fallback to the host loop."""
        gen = getattr(self.uniforms, "generator", None)
        if gen is None:
            raise ValueError(
                "fused_rounds='device' on the card captures the round into a "
                "CUDA graph, which draws from the Philox uniform source; run "
                "another uniform source with fused_rounds='host'")
        with _CAPTURE_LOCK:
            t0 = time.perf_counter()
            mark = self._mark_uniforms()
            cb.ctr.zero_()              # n = 0: every warm-up round is gated
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                for _ in range(_CAPTURE_WARMUP_ROUNDS):
                    self._round_step(cb)
            cur.wait_stream(side)
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            g = torch.cuda.CUDAGraph()
            g.register_generator_state(gen)
            # a capture launches nothing: its kernels run at each replay
            with build.recording() as recorded, torch.cuda.graph(
                    g, pool=self._graph_pool,
                    capture_error_mode="thread_local"):
                self._round_step(cb)
            cb.replay_launches = recorded
            self._rewind_uniforms(mark, 0)
        cb.graph = g
        cb.capture_s = time.perf_counter() - t0
        self.capture_seconds[cb.C] = cb.capture_s

    def sample(self, n: int):
        t0 = time.perf_counter()
        ss = self.sample_async(n).result()
        if n > 0:
            # feed the host-side cost model (t_round = c0 + c1 * slots)
            planner.PLAN_CACHE.observe(
                self._plan_cache_key, self.round_batch,
                int(sum(self.piece_batches)), self.last_rounds,
                time.perf_counter() - t0, n)
        return ss

    # -- telemetry (repro_torch.obs) -------------------------------------------
    def _obs_handles(self):
        """Lazily bound metric children (one registry lookup per engine),
        under the reference's names."""
        if self._obs_metrics is None:
            reg = obs.get_registry()
            per_piece = [
                reg.counter("repro_engine_piece_draws_total",
                            "candidate draws per cover piece", ("join",)),
                reg.counter("repro_engine_piece_accepts_total",
                            "cover-accepted candidates per piece", ("join",)),
                reg.counter("repro_engine_piece_residual_rejects_total",
                            "§8.2 residual rejections per piece", ("join",)),
                reg.counter("repro_engine_piece_bank_drained_total",
                            "rows served from the surplus bank", ("join",)),
            ]
            self._obs_metrics = {
                "piece": [[c.labels(join=n) for c in per_piece]
                          for n in self.order],
                "hwm": reg.gauge("repro_engine_piece_bank_hwm",
                                 "surplus-bank occupancy high-water mark",
                                 ("join",)),
                "waste": reg.gauge(
                    "repro_round_waste_ratio",
                    "1 - accepted/drawn per cover piece (cumulative)",
                    ("join",)),
                "ema": reg.gauge(
                    "repro_engine_piece_ema",
                    "adaptive-planner acceptance EMA (fraction of budget)",
                    ("join", "component")),
                "rounds": reg.counter("repro_engine_rounds_total",
                                      "fused Algorithm-1 rounds run"),
                "samples": reg.counter("repro_engine_samples_total",
                                       "samples emitted by the fused loop"),
                "dispatch": reg.histogram(
                    "repro_engine_dispatch_seconds",
                    "host wall-clock of sample(n) loop dispatch"),
                "drain": reg.histogram(
                    "repro_engine_drain_seconds",
                    "host wall-clock of result fetch + assembly"),
                "overlapped": reg.counter(
                    "repro_engine_overlapped_drains_total",
                    "drains run while a later call's rounds were in flight"),
            }
        return self._obs_metrics

    def _fold_piece_stats(self, p: np.ndarray, rounds: int = 0,
                          samples: int = 0,
                          ema: Optional[np.ndarray] = None) -> None:
        """Fold one call's per-piece counter matrix into the cumulative
        engine state (+ registry publication unless REPRO_OBS=off)."""
        p = np.asarray(p, np.int64)
        self.piece_stats[:, :4] += p[:, :4]
        self.piece_stats[:, 4] = np.maximum(self.piece_stats[:, 4], p[:, 4])
        self.stats.samples_emitted += int(samples)
        if not obs.enabled():
            return
        h = self._obs_handles()
        for j, name in enumerate(self.order):
            for i, child in enumerate(h["piece"][j]):
                v = int(p[j, i])
                if v:
                    child.inc(v)
            h["hwm"].labels(join=name).set(int(self.piece_stats[j, 4]))
            draws = int(self.piece_stats[j, 0])
            if draws:
                h["waste"].labels(join=name).set(
                    1.0 - int(self.piece_stats[j, 1]) / draws)
            if ema is not None:
                for i, comp in enumerate(planner.EMA_COMPONENTS):
                    h["ema"].labels(join=name, component=comp).set(
                        float(ema[j, i]) / planner.EMA_ONE)
        if rounds:
            h["rounds"].inc(int(rounds))
        if samples:
            h["samples"].inc(int(samples))


# ---------------------------------------------------------------------------
# Record-mode membership (the lazy orig_join record, Alg 1 l.8-12)
# ---------------------------------------------------------------------------


class TorchRecordUnionSampler(TorchUnionSampler):
    """Algorithm 1 with ``membership="record"``: the ``orig_join`` record as
    a device-resident sorted-fingerprint multiset.

    The record is four aligned device arrays of capacity ``R``: sorted
    64-bit row fingerprints as two 32-bit halves (``fp32`` salts 1 and 2,
    int64 tensors holding uint32 values; empty slots hold the all-ones
    sentinel pair and sort last), the tuple's current **home** piece, and
    the count of output rows currently credited to the entry.  A round is
    driven from the host in either ``fused_rounds`` mode (one sync per
    round: the lazy record semantics need the round's counts back) and processes the cover pieces in
    ascending order against the live record:

    * draw ``piece_batches[j]`` candidates (tree walk + §8.2 residual + the
      §8.3 predicate mask),
    * probe the record (``searchsorted`` + the ``_KWIN`` duplicate window):
      a candidate is **rejected** when its record home is an earlier piece
      (Alg 1 line 8), **revises** when its home is a later piece (lines
      10-12: the old entry's credited rows are debited and its home moves
      to ``j``), and is accepted otherwise,
    * take the first ``need_j`` accepted candidates in slot order (a
      truncation of an i.i.d. stream; no surplus banking, since banked rows
      could be invalidated by later revisions),
    * fold the taken rows into the record: revision flags scatter onto hit
      entries, missed fingerprints are deduplicated with run-length credit
      counts and merged by one sorted concatenation.

    Revision cannot rewrite rows already handed out, so emission is settled
    at the end of the call: an emitted row is kept iff its emit-time home
    equals its **final** record home, and the first ``n`` valid rows in
    emission order, shuffled, are the sample.  Per-round targets are a
    host ``multinomial`` from ``default_rng(seed)``, which also draws the
    output shuffle; the device uniforms come from ``uniforms.round(0, ...)``
    (no selection slot).
    """

    _KWIN = 8          # fp1 duplicate window (cf. TorchJoinMembership)
    _SENTINEL = 0xFFFFFFFF

    def __init__(self, backend: TorchBackend, cover, seed: int = 0,
                 round_batch: int = 4096, dead_rounds: int = 8,
                 max_rounds: int = 4096, surplus_cap: Optional[int] = None,
                 stats=None, fused_rounds: str = "device",
                 balance: str = "cover", balance_slack: float = 1.5,
                 uniforms=None, predicate=None, plan: str = "static",
                 record_capacity: Optional[int] = None):
        # budget masking would interleave with the lazy-record semantics
        if plan != "static":
            raise ValueError(
                "membership='record' supports plan='static' only")
        # the rounds are host-driven in either mode, as in the reference's
        # record engine: the lazy record needs each round's counts back
        super().__init__(backend, cover, seed=seed, round_batch=round_batch,
                         dead_rounds=dead_rounds, max_rounds=max_rounds,
                         surplus_cap=surplus_cap, stats=stats,
                         fused_rounds=fused_rounds, balance=balance,
                         balance_slack=balance_slack, uniforms=uniforms,
                         predicate=predicate)
        self.host_rng = np.random.default_rng(seed)
        self._sorted_attrs = tuple(sorted(self.attrs))
        self.record_capacity = record_capacity
        nj = len(self.order)
        self._dead = np.zeros(nj, dtype=bool)
        self._streak = np.zeros(nj, dtype=np.int64)
        self._rec: Optional[Dict[str, torch.Tensor]] = None
        self.R = 0

    def _init_record(self, n: int) -> Dict[str, torch.Tensor]:
        r = (int(self.record_capacity) if self.record_capacity is not None
             else 1 << max(12, (4 * int(n) - 1).bit_length()))
        self.R = r
        dev = self.device
        return {"f1": torch.full((r,), self._SENTINEL, dtype=torch.int64,
                                 device=dev),
                "f2": torch.full((r,), self._SENTINEL, dtype=torch.int64,
                                 device=dev),
                "home": torch.full((r,), 0x7FFFFFFF, dtype=torch.int32,
                                   device=dev),
                "emit": torch.zeros(r, dtype=torch.int32, device=dev),
                "count": torch.zeros((), dtype=torch.int64, device=dev),
                "fail": torch.zeros((), dtype=torch.bool, device=dev)}

    def _lookup(self, f1s, f2s, q1, q2):
        """First record position holding ``(q1, q2)`` within the duplicate
        window: ``(hit, pos)``."""
        R = f1s.shape[0]
        lo = torch.searchsorted(f1s, q1, side="left")
        hit = torch.zeros(q1.shape[0], dtype=torch.bool, device=q1.device)
        epos = torch.zeros(q1.shape[0], dtype=torch.int64, device=q1.device)
        for k in range(self._KWIN):
            pos = torch.clamp(lo + k, max=R - 1)
            m = (lo + k < R) & (f1s[pos] == q1) & (f2s[pos] == q2)
            epos = torch.where(m & ~hit, pos, epos)
            hit = hit | m
        return hit, epos

    def _record_round(self, st: Dict[str, torch.Tensor], need: torch.Tensor):
        """One round over the pieces in cover order; returns the new record
        state, the taken rows per piece and the (nj, 8) count matrix
        (taken, walk_ok, residual, pred, cover rejects, accepted, revisions,
        debited rows)."""
        dev = self.device
        R = self.R
        sent = self._SENTINEL
        _, u_joins = self.uniforms.round(
            0, [(t.n_streams, b) for t, b in zip(self.trees, self.piece_batches)])
        cols_out, counts = [], []
        for j, tree in enumerate(self.trees):
            bj = self.piece_batches[j]
            rows, acc, walk_ok = tree.draw(u_joins[j])
            okc, resc = walk_ok.sum(), walk_ok.sum() - acc.sum()
            acc, predc = self._pred_mask(j, rows, acc)
            f1 = fp32([rows[a] for a in self._sorted_attrs], salt=1)
            f2 = fp32([rows[a] for a in self._sorted_attrs], salt=2)
            # record lookup against the start-of-piece state
            hit, epos = self._lookup(st["f1"], st["f2"], f1, f2)
            home = st["home"][epos]
            rejc = (acc & hit & (home < j)).sum()
            accepted = acc & (~hit | (home >= j))
            rank = torch.cumsum(accepted, 0) - 1
            taken = accepted & (rank < need[j])
            ft = torch.minimum(accepted.sum(), need[j])
            # emit: taken rows compacted to the front (rank scatter)
            dst = torch.where(taken, torch.cumsum(taken, 0) - 1, bj)
            mat = torch.stack([rows[a] for a in self.attrs], dim=1)
            col = torch.zeros((bj + 1, mat.shape[1]), dtype=torch.int32,
                              device=dev)
            col[dst] = mat
            cols_out.append(col[:bj])
            # revisions: taken hits whose entry lives at a LATER piece —
            # debit the entry's credited rows, move its home to j
            th = taken & hit
            rev = th & (home > j)
            rev_flag = torch.zeros(R + 1, dtype=torch.bool, device=dev)
            rev_flag[torch.where(rev, epos, R)] = True
            rev_flag = rev_flag[:R]
            revc = rev_flag.sum()
            inval = torch.where(rev_flag, st["emit"], 0).sum()
            emit2 = torch.where(rev_flag, 0, st["emit"])
            home2 = torch.where(rev_flag, j, st["home"])
            emit2 = torch.cat([emit2, emit2.new_zeros(1)]).index_add_(
                0, torch.where(th, epos, R),
                torch.ones(bj, dtype=torch.int32, device=dev))[:R]
            # insert taken misses: lexicographic (f1, f2) sort → dedup →
            # run-length credit counts → one sorted-concat merge
            tm = taken & ~hit
            cf1 = torch.where(tm, f1, sent)
            cf2 = torch.where(tm, f2, sent)
            o = torch.argsort(cf2, stable=True)
            o = o[torch.argsort(cf1[o], stable=True)]
            sf1, sf2, stm = cf1[o], cf2[o], tm[o]
            first = torch.arange(bj, device=dev) == 0
            dup = (~first & (sf1 == torch.roll(sf1, 1))
                   & (sf2 == torch.roll(sf2, 1)))
            is_new = stm & ~dup
            g = torch.cumsum(is_new, 0) - 1
            cnt = torch.zeros(bj + 1, dtype=torch.int32, device=dev).index_add_(
                0, torch.where(stm, g, bj),
                torch.ones(bj, dtype=torch.int32, device=dev))[:bj]
            n_new = is_new.sum()
            new_emit = torch.where(is_new, cnt[torch.clamp(g, 0, bj - 1)], 0)
            nf1 = torch.where(is_new, sf1, sent)
            nf2 = torch.where(is_new, sf2, sent)
            nhome = torch.where(is_new, j, 0x7FFFFFFF).to(torch.int32)
            mf1 = torch.cat([st["f1"], nf1])
            morder = torch.argsort(mf1, stable=True)[:R]
            st = {"f1": mf1[morder],
                  "f2": torch.cat([st["f2"], nf2])[morder],
                  "home": torch.cat([home2, nhome])[morder],
                  "emit": torch.cat([emit2, new_emit.to(torch.int32)])[morder],
                  "count": st["count"] + n_new,
                  "fail": st["fail"] | (st["count"] + n_new > R)}
            counts.append(torch.stack([ft, okc, resc, predc, rejc,
                                       accepted.sum(), revc, inval]))
        return st, cols_out, torch.stack(counts)

    def sample_async(self, n: int):
        from ..union_sampler import empty_sample_set
        if n <= 0:
            return _ReadySample(empty_sample_set(list(self.attrs), self.stats))
        with self._on_device():
            return _ReadySample(self._sample_record(int(n)))

    def sample(self, n: int):
        return self.sample_async(n).result()

    def _sample_record(self, n: int):
        from ..relation import fingerprint128
        from ..union_sampler import SampleSet
        dev = self.device
        nj, bt = len(self.order), int(sum(self.piece_batches))
        if self._rec is None:
            self._rec = self._init_record(n)
        pbatch = np.asarray(self.piece_batches, np.int64)
        pstats = np.zeros((nj, len(PIECE_STAT_FIELDS)), np.int64)
        dead, streak = self._dead, self._streak
        base = self._probs_base.cpu().numpy().astype(np.float64)
        parts: List[Tuple[torch.Tensor, int]] = []   # emission order
        carry = np.zeros(nj, dtype=np.int64)
        valid = 0
        rounds = 0
        self.last_host_syncs = 0
        while valid < n:
            rounds += 1
            if rounds > self.max_rounds:
                raise RuntimeError(
                    "TorchRecordUnionSampler: top-up budget exhausted")
            probs = np.where(dead, 0.0, base)
            s = probs.sum()
            if s <= 0:
                raise RuntimeError("all cover pieces unreachable")
            extra = max(0, min(n - valid - int(carry.sum()), self.round_batch))
            need = carry + self.host_rng.multinomial(extra, probs / s)
            self._rec, cols, cnt = self._record_round(
                self._rec, torch.as_tensor(need, device=dev))
            # the one host sync of the round: counts and the capacity flag
            cnt = torch.cat([cnt.reshape(-1),
                             self._rec["fail"].to(torch.int64)[None]]).tolist()
            self.last_host_syncs += 1
            self.host_syncs += 1
            if cnt[-1]:
                raise RuntimeError(
                    f"TorchRecordUnionSampler: record capacity R={self.R} "
                    "exhausted; pass record_capacity= to size the multiset "
                    "for the expected distinct-tuple volume")
            c = np.asarray(cnt[:-1], np.int64).reshape(nj, 8)
            ft, okc, resc, predc, rejc, accc, revc, inval = c.T
            for j in range(nj):
                if ft[j]:
                    parts.append((cols[j][:ft[j]], j))
            valid += int(ft.sum()) - int(inval.sum())
            self.stats.iterations += bt
            self.stats.candidate_draws += bt
            self.stats.residual_rejects += int(resc.sum())
            self.stats.pred_rejects += int(predc.sum())
            self.stats.cover_rejects += int(rejc.sum())
            self.stats.revisions += int(revc.sum())
            self.stats.backtrack_removed += int(inval.sum())
            pstats[:, 0] += pbatch
            pstats[:, 1] += accc
            pstats[:, 2] += resc
            # no surplus banking in record mode: columns 3/4 stay zero
            shortfall = need - ft
            self.stats.dropped_slots += int(shortfall[dead].sum())
            shortfall[dead] = 0
            trig = (shortfall > 0) & (accc == 0)
            streak[:] = np.where(dead, streak, np.where(trig, streak + 1, 0))
            newly = ~dead & (streak >= self.dead_rounds)
            self.stats.dropped_slots += int(shortfall[newly].sum())
            shortfall[newly] = 0
            dead |= newly
            carry = shortfall
        self.last_rounds = rounds
        self.total_rounds += rounds
        self._fold_piece_stats(pstats, rounds=rounds, samples=n)
        # settle emission: keep rows whose emit-time home is still the final
        # record home (revised copies are exactly the ones whose home moved)
        mat = torch.cat([torch.cat([m, torch.full((m.shape[0], 1), j,
                                                  dtype=torch.int32,
                                                  device=dev)], dim=1)
                         for m, j in parts])
        by_attr = {a: mat[:, i] for i, a in enumerate(self.attrs)}
        q1 = fp32([by_attr[a] for a in self._sorted_attrs], salt=1)
        q2 = fp32([by_attr[a] for a in self._sorted_attrs], salt=2)
        found, pos = self._lookup(self._rec["f1"], self._rec["f2"], q1, q2)
        keep = found & (self._rec["home"][pos] == mat[:, -1])
        mat = mat[keep][:n].cpu().numpy().astype(np.int64)
        self.last_host_syncs += 1
        self.host_syncs += 1
        if mat.shape[0] < n:
            raise RuntimeError(
                "TorchRecordUnionSampler: settled emission came up short "
                f"({mat.shape[0]} < {n}) — record fingerprint collision")
        mat = mat[self.host_rng.permutation(n)]
        rows = {a: np.ascontiguousarray(mat[:, i])
                for i, a in enumerate(self.attrs)}
        home = np.ascontiguousarray(mat[:, -1])
        fp = fingerprint128([rows[a] for a in sorted(self.attrs)])
        return SampleSet(list(self.attrs), rows, home, fp, self.stats)

    def record_dict(self) -> Dict[int, Tuple[int, int]]:
        """The current record as ``{fp64: (home, credited_rows)}``."""
        if self._rec is None:
            return {}
        f1 = self._rec["f1"].cpu().numpy().astype(np.uint64)
        f2 = self._rec["f2"].cpu().numpy().astype(np.uint64)
        home = self._rec["home"].cpu().numpy()
        emit = self._rec["emit"].cpu().numpy()
        real = ~((f1 == self._SENTINEL) & (f2 == self._SENTINEL))
        return {int((f1[i] << np.uint64(32)) | f2[i]):
                (int(home[i]), int(emit[i]))
                for i in np.nonzero(real)[0]}
