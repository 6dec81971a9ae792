"""Card estimation engine — batched wander-join walks on the device.

Port of ``repro.core.estimators.jax_estimator``:

* :class:`TorchWalkJoin` — a batch of wander-join walks (§6.1): a uniform
  root position, then per relation in expansion order a composite-key range
  probe and a ranged uniform pick in one launch of the CUDA kernel
  ``kernels.probe.probe_pick`` (its plain PyTorch version on the CPU), with
  dead-walk masking and the per-walk probability
  ``p(t) = 1/|R_root| · Π 1/d_i`` in float32.  Residual (cycle-closing)
  edges are plain hops for wander join, so cyclic joins walk too (no
  ``Π d/M`` test).
* :class:`TorchRunning` — Horvitz–Thompson mean/variance accumulators kept
  as device scalars ``(count int32, mean float32, M2 float32)``; each batch
  folds in through Chan's associative merge in the reference's float32
  order.  Reads go to the host lazily.
* :class:`TorchEstimator` — walks + membership indicators (walk endpoints
  probed against :class:`~repro_torch.core.backends.torch_backend.
  TorchJoinMembership`) + the HT reduction into the ``|J|`` and ``|O_Δ|``
  accumulators on the device; only the walk pool (reuse, §7) comes back to
  the host, one copy per batch.
* :class:`TorchHistogramOverlap` — §5 / Theorem 4 join-size and overlap
  bounds with the per-value histogram algebra (intersect / min / sum) as
  torch ops.

``mesh=`` (a :func:`~repro_torch.core.sharding.make_sampler_mesh` mesh)
runs each observation as ``world`` walk batches, one per rank; the
per-rank HT moments merge in :func:`~repro_torch.core.sharding.
psum_merge_moments` (three ``all_reduce`` sums for both accumulators) and
the walk pool keeps every rank's batch, flattened in rank order (one
``all_gather``).  At world 1 the walks come from the unsharded stream and
no collective runs.

Random numbers come from a **walk stream**: ``uniforms.walk(n_root, n_hops,
batch)`` returns the root positions (int64) and the ``(n_hops, batch)``
float32 hop uniforms of one batch.  Production uses
:class:`~repro_torch.core.backends.torch_backend.PhiloxUniforms`; tests
replay the reference's JAX key schedule through the same method.

Limits match the device engine: non-negative dict-encoded values whose
packed edge-key domains fit in int32 (checked at build time).
"""

from __future__ import annotations

import math
from typing import Dict, FrozenSet, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import mesh_device, resolve_device
from ...kernels.probe import probe_pick, probe_pick_plain
from ..backends.torch_backend import (PhiloxUniforms, TorchJoinMembership,
                                      _I32_LIM, _attr_widths, _cached_col,
                                      _cached_node_index,
                                      _device_index_cache, _pack)
from ..index import Catalog
from ..joins import JoinSpec
from ..overlap import HistogramOverlap
from ..sharding.stats import psum_merge_moments
from ..size_estimation import z_value
from .base import EstimationLoop, OverlapEstimate, PoolBatch, ReservoirPool

Rows = Dict[str, torch.Tensor]

_TINY = 1e-30
POOL_CAP = 512          # walk tuples kept per join for reuse


# ---------------------------------------------------------------------------
# Device walker: batched wander-join walks over one join
# ---------------------------------------------------------------------------


class TorchWalkJoin:
    """One join prepared for batched wander-join walks on ``device``.

    Wander join does no semi-join reduction, so the walk indexes the spec's
    own relations (through the catalog's device index cache, shared with
    any other walker or masked tree join over the same relation)."""

    def __init__(self, cat: Catalog, spec: JoinSpec, device=None):
        self.device = resolve_device(device)
        self.name = spec.name
        self.spec = spec
        self.attrs = tuple(spec.output_attrs)
        order = spec.expansion_order()
        widths = _attr_widths(spec)
        cache = _device_index_cache(cat)
        self.node_edge_attrs: List[Tuple[str, ...]] = []
        self.node_radices: List[Tuple[int, ...]] = []
        self.sorted_keys: List[torch.Tensor] = []
        self.perm: List[torch.Tensor] = []
        self.cols: List[Dict[str, torch.Tensor]] = []
        root_rel = order[0].relation
        produced = set(root_rel.attrs)
        for n in order[1:]:
            rel = n.relation
            radices = tuple(widths[a] for a in n.edge_attrs)
            dom = 1
            for w in radices:
                dom *= w
            if dom >= _I32_LIM:
                raise ValueError(
                    f"torch estimator: packed edge-key domain of node "
                    f"{n.alias!r} ({dom}) exceeds int32")
            _, skeys, perm = _cached_node_index(
                cache, rel, tuple(n.edge_attrs), radices, self.device)
            new_attrs = tuple(a for a in rel.attrs if a not in produced)
            produced.update(rel.attrs)
            self.node_edge_attrs.append(tuple(n.edge_attrs))
            self.node_radices.append(radices)
            self.sorted_keys.append(skeys)
            self.perm.append(perm)
            self.cols.append({a: _cached_col(cache, rel, a, self.device)
                              for a in rel.columns if a in new_attrs})
        self.root_cols = {a: _cached_col(cache, root_rel, a, self.device)
                          for a in root_rel.columns}
        self.n_root = root_rel.nrows
        self.n_hops = len(self.sorted_keys)
        self._empty = (self.n_root == 0 or
                       any(k.shape[0] == 0 for k in self.sorted_keys))

    def is_empty(self) -> bool:
        return self._empty

    def draw(self, r_pos: torch.Tensor, u: torch.Tensor, plain: bool = False
             ) -> Tuple[Rows, torch.Tensor, torch.Tensor]:
        """One batch of walks from root positions ``r_pos`` (int64) and hop
        uniforms ``u`` (``(n_hops, batch)`` float32): ``(rows, p(t), ok)``,
        ``p(t) = 0`` for dead walks.  ``plain=True`` swaps the CUDA kernel
        for its plain PyTorch version (the on-card comparison of the two)."""
        if u.dim() != 2 or u.shape[0] != self.n_hops:
            raise ValueError(f"{self.name}: walk needs ({self.n_hops}, batch)"
                             f" uniforms, got {tuple(u.shape)}")
        pick = probe_pick_plain if plain else probe_pick
        batch = r_pos.shape[0]
        rows = {a: c[r_pos] for a, c in self.root_cols.items()}
        ok = torch.full((batch,), self.n_root > 0, dtype=torch.bool,
                        device=r_pos.device)
        prob = torch.full((batch,), 1.0 / max(self.n_root, 1),
                          dtype=torch.float32, device=r_pos.device)
        for i, (edge_attrs, radices) in enumerate(
                zip(self.node_edge_attrs, self.node_radices)):
            q = _pack(rows, edge_attrs, radices)
            pos, d = pick(self.sorted_keys[i], q, u[i])
            alive = ok & (d > 0)
            prob = torch.where(
                alive, prob / torch.clamp(d, min=1).to(torch.float32),
                torch.zeros_like(prob))
            ok = alive
            n_i = self.perm[i].shape[0]
            child = self.perm[i][torch.clamp(pos, 0, n_i - 1).long()]
            for a, c in self.cols[i].items():
                rows[a] = c[child]
        return rows, prob, ok


# ---------------------------------------------------------------------------
# Device-resident HT accumulators
# ---------------------------------------------------------------------------


def _batch_moments(x: torch.Tensor):
    """(n, mean, M2) of one batch — every element counts (zeros included)."""
    mean = torch.mean(x)
    m2 = torch.sum((x - mean) ** 2)
    return (torch.full((), x.shape[0], dtype=torch.int32, device=x.device),
            mean, m2)


def _merge_moments(count, mean, m2, bn, bmean, bm2):
    """Chan's associative merge — the batched form of Welford's update."""
    n = count + bn
    nf = torch.clamp(n.to(torch.float32), min=1.0)
    bnf = bn.to(torch.float32)
    d = bmean - mean
    return (n,
            mean + d * bnf / nf,
            m2 + bm2 + d * d * count.to(torch.float32) * bnf / nf)


class TorchRunning:
    """Running mean/variance kept as device scalars (count, mean, M2).

    Read surface matches :class:`~repro_torch.core.size_estimation.
    RunningMean` (``count`` / ``mean`` / ``variance`` / ``half_width``);
    reads pull the scalars to the host lazily."""

    def __init__(self, device):
        dev = torch.device(device)
        self.state = (torch.zeros((), dtype=torch.int32, device=dev),
                      torch.zeros((), dtype=torch.float32, device=dev),
                      torch.zeros((), dtype=torch.float32, device=dev))

    @property
    def count(self) -> int:
        return int(self.state[0])

    @property
    def mean(self) -> float:
        return float(self.state[1])

    @property
    def m2(self) -> float:
        return float(self.state[2])

    @property
    def variance(self) -> float:
        c = self.count
        return self.m2 / (c - 1) if c > 1 else 0.0

    def half_width(self, confidence: float = 0.90) -> float:
        c = self.count
        if c < 2:
            return math.inf
        return z_value(confidence) * math.sqrt(self.variance / c)

    def update_zeros(self, n: int) -> None:
        """Fold in ``n`` all-zero observations (walks on an empty join)."""
        z = torch.zeros((), dtype=torch.float32, device=self.state[0].device)
        self.state = _merge_moments(
            *self.state, torch.full((), n, dtype=torch.int32, device=z.device),
            z, z)


# ---------------------------------------------------------------------------
# The estimator backend
# ---------------------------------------------------------------------------


class TorchEstimator(EstimationLoop):
    """Card-resident |J| / |O_Δ| estimation: walks + probes + HT.

    ``device=None`` means the card and raises without one.  ``members``
    shares a sampling backend's membership indexes (OnlineUnionSampler
    passes them); ``uniforms`` replaces the Philox walk stream seeded from
    ``seed``.  With ``mesh=`` at world > 1, rank ``r`` walks on a stream
    seeded ``rank_stream_seed(seed, r, WALK_STREAM)``."""

    name = "torch"

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec], seed: int = 0,
                 batch: int = 512,
                 members: Optional[Dict[str, TorchJoinMembership]] = None,
                 device=None, uniforms=None, mesh=None):
        self.device = resolve_device(mesh_device(mesh, device))
        self.mesh = mesh
        self.world = mesh.world if mesh is not None else 1
        if uniforms is None and self.world > 1:
            from ..sharding.catalog import WALK_STREAM, rank_stream_seed
            uniforms = PhiloxUniforms(
                rank_stream_seed(seed, mesh.rank, WALK_STREAM), self.device)
        self.cat = cat
        self.joins = list(joins)
        schemas = {tuple(sorted(j.output_attrs)) for j in self.joins}
        if len(schemas) > 1:
            raise ValueError(
                f"joins must share an output schema; got {sorted(schemas)}")
        self.batch = int(batch)
        self.uniforms = (uniforms if uniforms is not None
                         else PhiloxUniforms(seed, self.device))
        self.walkers: Dict[str, TorchWalkJoin] = {
            j.name: TorchWalkJoin(cat, j, device=self.device)
            for j in self.joins}
        self.members: Dict[str, TorchJoinMembership] = (
            members if members is not None
            else {j.name: TorchJoinMembership(j, device=self.device)
                  for j in self.joins})
        self._stats: Dict[FrozenSet[str], TorchRunning] = {}
        self._size_stats: Dict[str, TorchRunning] = {}
        self._pool = ReservoirPool(cap=POOL_CAP, seed=seed)

    # -- accumulator views / pool ---------------------------------------------
    @property
    def size_stats(self) -> Mapping[str, TorchRunning]:
        return self._size_stats

    @property
    def overlap_stats(self) -> Mapping[FrozenSet[str], TorchRunning]:
        return self._stats

    @property
    def walk_pool(self) -> Dict[str, List[PoolBatch]]:
        return self._pool.pools

    def drain_pool(self) -> Dict[str, List[PoolBatch]]:
        return self._pool.drain()

    # -- observation ----------------------------------------------------------
    def observe(self, delta: Sequence[JoinSpec], rounds: int = 1
                ) -> OverlapEstimate:
        """Run ``rounds`` walk+probe batches on Δ's pivot."""
        delta = list(delta)
        dkey = frozenset(j.name for j in delta)
        stat = self._stats.setdefault(dkey, TorchRunning(self.device))
        pivot = self._pivot(delta)
        sstat = self._size_stats.setdefault(pivot.name,
                                            TorchRunning(self.device))
        walker = self.walkers[pivot.name]
        if walker.is_empty():
            # every walk fails: HT draws are observations of zero
            for _ in range(rounds):
                sstat.update_zeros(self.batch * self.world)
                stat.update_zeros(self.batch * self.world)
            return OverlapEstimate(stat.mean, stat.half_width(0.90), stat.count)
        members = [self.members[n] for n in
                   sorted(j.name for j in delta if j.name != pivot.name)]
        attrs = list(walker.attrs)
        for _ in range(rounds):
            r_pos, u = self.uniforms.walk(walker.n_root, walker.n_hops,
                                          self.batch)
            rows, prob, ok = walker.draw(r_pos, u)
            inv = torch.where(ok & (prob > 0),
                              1.0 / torch.clamp(prob, min=_TINY),
                              torch.zeros_like(prob))
            ind = ok
            fp_cache: Dict = {}
            for m in members:
                ind = ind & m.contains(rows, fp_cache)
            contrib = torch.where(ind, inv, torch.zeros_like(inv))
            smom, omom = _batch_moments(inv), _batch_moments(contrib)
            if self.mesh is not None:
                # both accumulators' batch moments, merged over the ranks
                n, mean, m2 = psum_merge_moments(
                    *(torch.stack([a, b]) for a, b in zip(smom, omom)),
                    self.mesh)
                smom, omom = (n[0], mean[0], m2[0]), (n[1], mean[1], m2[1])
            sstat.state = _merge_moments(*sstat.state, *smom)
            stat.state = _merge_moments(*stat.state, *omom)
            # the pool batch in one device→host copy (prob bit-cast to int32)
            mat = torch.stack([rows[a] for a in attrs]
                              + [prob.view(torch.int32)], dim=1)
            if self.world > 1:
                # every rank's batch, flattened in rank order
                import torch.distributed as dist
                g = torch.empty(self.world * mat.numel(), dtype=mat.dtype,
                                device=mat.device)
                dist.all_gather_into_tensor(g, mat.reshape(-1),
                                            group=self.mesh.group)
                mat = g.view(-1, mat.shape[1])
            mat = mat.cpu().numpy()
            self._pool.add(pivot.name, (
                {a: mat[:, i].astype(np.int64) for i, a in enumerate(attrs)},
                np.ascontiguousarray(mat[:, -1]).view(np.float32)
                .astype(np.float64)))
        return OverlapEstimate(stat.mean, stat.half_width(0.90), stat.count)

    # -- §5 initialisation ----------------------------------------------------
    def histogram(self, mode: str = "max") -> "TorchHistogramOverlap":
        return TorchHistogramOverlap(self.cat, self.joins, mode=mode,
                                     device=self.device)


# ---------------------------------------------------------------------------
# Device histogram overlap (§5 / Theorem 4 on the device)
# ---------------------------------------------------------------------------


def _lookup_sorted(v: torch.Tensor, c: torch.Tensor, valid: torch.Tensor,
                   q: torch.Tensor):
    """Per-query (hit, count) lookup into a sorted unique value histogram."""
    n = v.shape[0]
    if n == 0:
        return (torch.zeros(q.shape[0], dtype=torch.bool, device=q.device),
                torch.zeros(q.shape[0], dtype=torch.float32, device=q.device))
    pos = torch.searchsorted(v, q)
    posc = torch.clamp(pos, 0, n - 1)
    hit = (pos < n) & (v[posc] == q) & valid[posc]
    return hit, torch.where(hit, c[posc], torch.zeros_like(c[posc]))


class TorchHistogramOverlap(HistogramOverlap):
    """§5 histogram bounds with the per-value algebra as device ops.

    The split-plan construction and the Theorem-4 scalar multipliers stay on
    the host (O(#pairs) scalars); the per-value histogram intersection,
    min-reduction and summation over the first-edge domain K(1) run as
    torch ops over device-resident histograms.  Counts are float32 on the
    device: exact for integer counts below 2^24."""

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec],
                 mode: str = "max", cap_with_join_bound: bool = True,
                 device=None):
        super().__init__(cat, joins, mode=mode,
                         cap_with_join_bound=cap_with_join_bound)
        self.device = resolve_device(device)
        self._dev_hists: Dict[Tuple[str, int, str],
                              Tuple[torch.Tensor, torch.Tensor]] = {}

    def _pair_hist_dev(self, plan, i: int, attr: str
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        key = (plan.join.name, i, attr)
        if key not in self._dev_hists:
            vals, counts = self._pair_degree_hist(plan, i, attr)
            self._dev_hists[key] = (
                torch.as_tensor(vals.astype(np.int64), device=self.device),
                torch.as_tensor(counts.astype(np.float32), device=self.device))
        return self._dev_hists[key]

    def estimate(self, delta: Sequence[JoinSpec]) -> float:
        """Upper bound (mode='max') or refined estimate (mode='avg') of |O_Δ|."""
        delta = list(delta)
        if len(delta) == 1:
            return float(self._join_bounds[delta[0].name])
        plans = [self.plans[j.name] for j in delta]
        k = len(self.template) - 1  # number of pairs

        # K(1): per join, the per-value count over the first edge's shared
        # attr (pair0 × pair1 when the edge is real), as (values, counts,
        # valid) device triples; masks stand in for materialised
        # intersections
        first_attr = self.template[1]
        per_join: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = []
        for plan in plans:
            v0, c0 = self._pair_hist_dev(plan, 0, first_attr)
            valid0 = torch.ones(v0.shape[0], dtype=torch.bool,
                                device=self.device)
            if k >= 2:
                p1 = plan.pairs[1]
                if p1.fake_edge_to_prev:
                    # row identity: pairs with A2=v == d(v) rows
                    per_join.append((v0, c0, valid0))
                    continue
                v1, c1 = self._pair_hist_dev(plan, 1, first_attr)
                hit, cc = _lookup_sorted(
                    v1, c1, torch.ones(v1.shape[0], dtype=torch.bool,
                                       device=self.device), v0)
                per_join.append((v0, c0 * cc, hit))
            else:
                per_join.append((v0, c0, valid0))

        # intersect the value domains across joins and take the min count
        base_v, acc, valid = per_join[0]
        for v2, c2, m2 in per_join[1:]:
            hit, cc = _lookup_sorted(v2, c2, m2, base_v)
            valid = valid & hit
            acc = torch.minimum(acc, torch.where(hit, cc,
                                                 torch.full_like(cc, math.inf)))
        k1 = float(torch.sum(torch.where(valid, acc, torch.zeros_like(acc))))
        if k1 <= 0:
            return 0.0

        # K(i) for the remaining pairs: multiply by min over joins of M_{j,i}
        bound = k1
        for i in range(2, k):
            bound *= min(self._pair_multiplier(plan, i) for plan in plans)
        if self.cap:
            bound = min(bound, min(self._join_bounds[j.name] for j in delta))
        return float(bound)
