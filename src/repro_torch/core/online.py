"""§7: ONLINE-UNION sampling (Algorithm 2) — reuse + backtracking.

Port of ``repro.core.online``.  Initialises cheaply with the
HISTOGRAM-BASED parameters, then refines join / overlap / union estimates on
the fly with RANDOM-WALK batches while sampling.

* **Sample reuse** (Alg 2 lines 8-10): walk tuples collected by the
  estimator carry exact probabilities ``p(t)``.  When join ``J_j`` is
  selected and its pool is non-empty, a pooled tuple drawn uniformly is
  accepted with ``R = 1/(p(t)·|J_j|)``; ``R > 1`` is handled as ``⌊R⌋``
  copies plus a Bernoulli(frac) extra copy.
* **Backtracking with parameter update** (Alg 2 lines 18-20): every ``φ``
  recorded candidate probabilities, parameters are re-estimated from the
  accumulated walks and previously accepted samples are thinned with
  probability proportional to the new-to-old selection ratio (normalised by
  its maximum).  Backtracking stops once the estimate confidence reaches
  ``γ``.

The histogram initialisation, the wander-join walks, the membership probes
and the Horvitz–Thompson accumulators run on the card
(:class:`~repro_torch.core.estimators.torch_estimator.TorchEstimator`,
sharing the sampling backend's membership indexes); fresh candidates come
from :class:`~repro_torch.core.backends.torch_backend.TorchCandidateSource`.
Selection, reuse acceptance and backtracking stay on the host with the
reference's ``numpy.random.Generator``, so one seed makes the same host
decisions in both packages.
"""

from __future__ import annotations

import dataclasses
import itertools
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..device import mesh_device
from .. import obs
from ..obs import TraceRing
from .backends import Backend, get_backend
from .cover import Cover, build_cover
from .estimators import EstimatorBackend, get_estimator
from .framework import estimate_union
from .index import Catalog
from .joins import JoinSpec
from .koverlap import OverlapOracle
from .planner import PiecePlanner
from .predicates import (pred_mask_np, scaled_overlap_estimate,
                         selectivity_factor)
from .relation import fingerprint128
from .size_estimation import olken_bound
from .union_sampler import (SampleSet, SamplerStats, _baseline_sources,
                            pop_residual_rejects)

Rows = Dict[str, np.ndarray]

GAMMA = 0.90                   # confidence of the overlap CIs that end backtracking
TARGET_REL_HALFWIDTH = 0.15    # ... once every pairwise half-width is this tight
WARM_ROUNDS = 2                # walk rounds per join before the first candidate
TRACE_CAPACITY = 256           # φ-trajectory events kept


@dataclasses.dataclass
class _Accepted:
    values: Dict[str, int]
    home: int
    sel_ratio: float    # |J'_h|/|U| under the parameters at acceptance time


class OnlineUnionSampler:
    """Algorithm 2: histogram init + random-walk refinement + reuse + backtrack.

    ``backend`` is ``"torch"`` (the card's engine; ``device=None`` means
    the card and raises without one, ``device="cpu"`` runs the plain
    PyTorch path), ``"numpy"`` (the host engine) or a
    :class:`~repro_torch.core.backends.base.Backend` instance.  The
    estimator follows the backend unless ``estimator=`` names one; a custom
    backend without an estimator twin falls back to the host estimator
    with a warning and a ``repro_engine_fallback_total{reason=
    "estimator_backend"}`` event, as in the reference.  ``uniforms``
    replaces the device Philox streams: an object with the estimator's
    ``walk(n_root, n_hops, batch)`` and ``source(i)``, the stream of join
    ``i``'s candidate source (tests replay the reference's JAX keys
    through it).  ``mesh=`` refines the parameters from walks on every rank
    of the mesh (the device estimator's mesh path); the sampling itself is
    the same on every rank."""

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec], seed: int = 0,
                 phi: int = 2048, rw_batch: int = 256,
                 order: Optional[Sequence[str]] = None,
                 backend: str | Backend = "torch",
                 estimator: Optional[str | EstimatorBackend] = None,
                 mesh=None, predicate=None,
                 plan: str = "static", device=None, uniforms=None,
                 join_method: str = "ew"):
        if plan not in ("static", "adaptive"):
            raise ValueError(f"plan must be 'static' or 'adaptive', got {plan!r}")
        if estimator is not None:
            est_spec = estimator            # explicit; unknown strings raise
        elif isinstance(backend, str):
            est_spec = backend              # follow the sampling backend
        else:
            est_spec = getattr(backend, "name", "numpy")
            if est_spec not in ("numpy", "torch"):
                warnings.warn(
                    f"OnlineUnionSampler: no estimator backend for custom "
                    f"sampling backend {est_spec!r}; refinement walks fall "
                    "back to the host engine (pass estimator= to override)",
                    stacklevel=2)
                obs.record_fallback(
                    "estimator_backend",
                    detail=f"custom sampling backend {est_spec!r} has no "
                           "estimator twin; refinement walks use numpy")
                est_spec = "numpy"
        if mesh is not None and est_spec != "torch":
            raise ValueError("mesh= needs the device estimator; use "
                             "backend='torch' (or estimator='torch')")
        device = mesh_device(mesh, device)
        self.plan = plan
        self.cat = cat
        self.joins = list(joins)
        self.names = [j.name for j in self.joins]
        self._by_name = {j.name: j for j in self.joins}
        # §8.3 predicates: per-join reject_preds AND the union-wide
        # RejectingPredicate gate fresh draws and reuse-pool candidates
        # (counted in stats.pred_rejects); the membership prober applies
        # each piece's own reject_preds internally
        self.predicate = predicate
        gp = tuple(predicate.preds) if predicate is not None else ()
        self._own_preds = {j.name: tuple(j.reject_preds) + gp
                           for j in self.joins}
        # get_backend raises on unknown backend strings (no silent fallback)
        self.backend = get_backend(backend, cat, self.joins, join_method,
                                   seed, device)
        self.device = getattr(self.backend, "device", None)
        self.prober = self.backend.oracle()
        self.attrs = list(self.joins[0].output_attrs)
        self.rng = np.random.default_rng(seed)
        self.phi = phi
        self.stats = SamplerStats()

        # (2 — built first so (1) can consume its histogram oracle) the
        # device estimator shares the backend's device membership indexes
        est_kwargs = {}
        if est_spec == "torch":
            members = getattr(self.backend, "members", None)
            if members is not None:
                est_kwargs["members"] = members
            est_kwargs.update(device=self.device or device,
                              uniforms=uniforms, mesh=mesh)
        self.estimator = get_estimator(est_spec, cat, self.joins,
                                       seed=seed + 1, batch=rw_batch,
                                       **est_kwargs)

        # (1) cheap init: HISTOGRAM-BASED parameters (device ops).  §8.3:
        # overlaps of filtered joins are scaled by predicate selectivity
        # (olken_bound scales per-join internally)
        hist = self.estimator.histogram()
        est_fn = hist.estimate
        if any(j.reject_preds for j in self.joins):
            est_fn = scaled_overlap_estimate(hist.estimate)
        oracle = OverlapOracle(est_fn,
                               lambda j: olken_bound(cat, j), self.joins)
        est = estimate_union(oracle, order)
        self.cover: Cover = est.cover
        self.order = list(self.cover.order)
        # plan="adaptive": the fresh-draw retry path batches its draws by the
        # fixed-point acceptance EMAs (ceil(1/ema) candidates per retry);
        # φ-refreshes reseed them from the rebuilt cover
        self.planner = (PiecePlanner(self.cover, self._by_name)
                        if plan == "adaptive" else None)

        # φ-trajectory tracer: the recent refinement history, bounded
        self.trace = TraceRing(capacity=TRACE_CAPACITY)
        self.refresh_count = 0          # φ-batch refreshes performed so far
        self._obs_m = None
        self.last_refresh_at = -1       # stats.iterations at the last refresh
        self._hist_sizes = {n: float(self.cover.join_sizes[n])
                            for n in self.names}
        self.trace.append(
            "init",
            union_size=float(self.cover.union_size),
            piece_sizes={n: float(self.cover.piece_sizes[n])
                         for n in self.order},
            join_sizes=dict(self._hist_sizes),
            order=list(self.order))

        for j in self.joins:            # tiny warm start so sizes exist
            for _ in range(WARM_ROUNDS):
                self.estimator.observe([j], rounds=1)
        self._refresh_pools()
        self._refresh_size_cache()

        self.sources = dict(zip(
            self.names, _baseline_sources(self.backend, self.joins, uniforms)))
        self._accepted: List[_Accepted] = []
        self._since_refresh = 0
        self._confident = False

    # ------------------------------------------------------------------ pools
    def _refresh_pools(self) -> None:
        """Flatten drained walk-pool batches into per-join candidate lists."""
        self.pools: Dict[str, List[Tuple[Dict[str, int], float]]] = {}
        for name, batches in self.estimator.drain_pool().items():
            entries: List[Tuple[Dict[str, int], float]] = []
            for rows, prob in batches:
                idx = np.nonzero(prob > 0)[0]
                for i in idx:
                    entries.append(({a: int(rows[a][i]) for a in self.attrs},
                                    float(prob[i])))
            self.pools[name] = entries

    # ------------------------------------------------------------- parameters
    def _sel_ratio(self, oidx: int) -> float:
        u = max(self.cover.union_size, 1e-12)
        return self.cover.piece_sizes[self.order[oidx]] / u

    def _selection_probs(self) -> np.ndarray:
        p = np.array([max(self.cover.piece_sizes[n], 0.0) for n in self.order])
        s = p.sum()
        return p / s if s > 0 else np.full(len(p), 1.0 / len(p))

    def _refresh_size_cache(self) -> None:
        """Pull the walk-refined join sizes to the host, once per refresh.

        ``size_stats`` are device accumulators: every ``.count`` / ``.mean``
        read is a device→host sync.  They change only when the estimator
        observes, so the per-candidate reuse test reads this host memo."""
        cache: Dict[str, float] = {}
        for name in self.names:
            st = self.estimator.size_stats.get(name)
            if st is not None and st.count > 0 and st.mean > 0:
                # wander-join walks estimate the unfiltered join; scale by
                # the §8.3 predicate selectivity so reuse acceptance and the
                # refined cover see the *filtered* size
                cache[name] = (st.mean
                               * selectivity_factor(self._by_name[name]))
            else:
                cache[name] = max(self.cover.join_sizes[name], 1.0)
        self._size_est_cache = cache

    def _join_size_est(self, name: str) -> float:
        return self._size_est_cache[name]

    def _refresh_parameters(self) -> None:
        """Re-estimate sizes/overlaps from walks; rebuild cover; backtrack."""
        removed_before = self.stats.backtrack_removed
        old_ratio = {i: self._sel_ratio(i) for i in range(len(self.order))}
        # fresh walk rounds for every pair (budgeted)
        for a, b in itertools.combinations(self.joins, 2):
            self.estimator.observe([a, b], rounds=1)
        if len(self.joins) > 2:
            self.estimator.observe(self.joins, rounds=1)
        self._refresh_pools()
        self._refresh_size_cache()
        ostats = self.estimator.overlap_stats
        est_fn = (lambda d: ostats[frozenset(j.name for j in d)].mean
                  if frozenset(j.name for j in d) in ostats else 0.0)
        if any(j.reject_preds for j in self.joins):
            # walks sample the unfiltered joins (membership probes are
            # already pred-aware) — scale like framework.warmup does
            est_fn = scaled_overlap_estimate(est_fn)
        oracle = OverlapOracle(est_fn,
                               lambda j: self._join_size_est(j.name),
                               self.joins)
        self.cover = build_cover(oracle, self.order)
        if self.planner is not None:
            # refined parameters invalidate the learned acceptance rates
            self.planner.reseed(self.cover, self._by_name)
        # ---- backtracking ----
        new_ratio = {i: self._sel_ratio(i) for i in range(len(self.order))}
        r = {i: (new_ratio[i] / old_ratio[i]) if old_ratio[i] > 0 else 1.0
             for i in range(len(self.order))}
        rmax = max(r.values()) if r else 1.0
        if rmax > 0:
            kept: List[_Accepted] = []
            for s in self._accepted:
                cur = (self.cover.piece_sizes[self.order[s.home]]
                       / max(self.cover.union_size, 1e-12))
                ratio = (cur / s.sel_ratio) if s.sel_ratio > 0 else 1.0
                q = min(ratio / rmax, 1.0)
                if self.rng.random() < q:
                    s.sel_ratio = cur
                    kept.append(s)
                else:
                    self.stats.backtrack_removed += 1
            self._accepted = kept
            # confidence check (γ): all pairwise overlap CIs tight enough?
            hw_ok = True
            for key, st in self.estimator.overlap_stats.items():
                if len(key) < 2 or st.count < 8:
                    continue
                if (st.mean > 0 and st.half_width(GAMMA)
                        > TARGET_REL_HALFWIDTH * st.mean):
                    hw_ok = False
            self._confident = hw_ok
        # ---- trace + metrics ----
        removed = self.stats.backtrack_removed - removed_before
        self.refresh_count += 1
        self.last_refresh_at = self.stats.iterations
        self.trace.append(
            "refresh",
            at_iteration=int(self.stats.iterations),
            union_size=float(self.cover.union_size),
            piece_sizes={n: float(self.cover.piece_sizes[n])
                         for n in self.order},
            sel_ratio={self.order[i]: float(new_ratio[i])
                       for i in range(len(self.order))},
            hist_gap=self.histogram_gaps(),
            kept=len(self._accepted), removed=int(removed),
            confident=bool(self._confident))
        if obs.enabled():
            m = self._obs_handles()
            m["refreshes"].inc()
            if removed:
                m["backtracked"].inc(removed)
            m["union"].set(float(self.cover.union_size))

    def histogram_gaps(self) -> Dict[str, float]:
        """Relative gap between the histogram init bound and the current
        walk-refined size estimate, per member join: ``(hist - walk)/hist``.
        Large positive gaps mean the cheap histogram bound overshot."""
        out = {}
        for name in self.names:
            hist = self._hist_sizes.get(name, 0.0)
            out[name] = (hist - self._join_size_est(name)) / max(hist, 1.0)
        return out

    @property
    def backtrack_count(self) -> int:
        """Total accepted samples removed by backtracking (all refreshes)."""
        return self.stats.backtrack_removed

    def _obs_handles(self):
        """The refinement series, under the reference's names."""
        if self._obs_m is None:
            reg = obs.get_registry()
            self._obs_m = {
                "refreshes": reg.counter(
                    "repro_online_refreshes_total",
                    "phi-batch parameter refreshes performed"),
                "backtracked": reg.counter(
                    "repro_online_backtrack_removed_total",
                    "accepted samples removed by backtracking"),
                "union": reg.gauge(
                    "repro_online_union_size",
                    "current union-size estimate after refinement"),
            }
        return self._obs_m

    # ---------------------------------------------------------------- accept
    def _cover_accept(self, oidx: int, rows: Rows) -> np.ndarray:
        n = next(iter(rows.values())).shape[0]
        keep = np.ones(n, dtype=bool)
        for i in range(oidx):
            if not keep.any():
                break
            keep &= ~self.prober.contains(self.order[i], rows)
        return keep

    def _try_reuse(self, name: str, oidx: int) -> List[_Accepted]:
        """One reuse attempt (Alg 2 line 8). Returns accepted copies (may be >1)."""
        pool = self.pools.get(name, [])
        if not pool:
            return []
        k = int(self.rng.integers(0, len(pool)))
        values, p = pool.pop(k)
        preds = self._own_preds[name]
        if preds:
            rows1 = {a: np.asarray([values[a]]) for a in self.attrs}
            if not bool(pred_mask_np(preds, rows1)[0]):
                self.stats.pred_rejects += 1
                return []
        # |J_j| is predicate-scaled (see _join_size_est), so surviving pool
        # tuples are emitted uniformly over the *filtered* join.  Each pool
        # entry is an independent walk outcome: R = 1/(p(t)·|J_j|) makes
        # P(emit t) = 1/|J_j|; R > 1 is ⌊R⌋ copies + Bernoulli(frac)
        jsize = self._join_size_est(name)
        R = 1.0 / max(p * jsize, 1e-300)
        copies = int(np.floor(R)) + (1 if self.rng.random() < (R - np.floor(R)) else 0)
        if copies == 0:
            self.stats.reuse_rejects += 1
            return []
        rows = {a: np.asarray([values[a]], dtype=np.int64) for a in self.attrs}
        if not bool(self._cover_accept(oidx, rows)[0]):
            self.stats.cover_rejects += 1
            return []
        self.stats.reuse_accepts += copies
        ratio = self._sel_ratio(oidx)
        return [_Accepted(dict(values), oidx, ratio) for _ in range(copies)]

    # ----------------------------------------------------------- fresh draws
    def _fresh_static(self, name: str, oidx: int,
                      retry_rounds: int) -> Optional[Rows]:
        """One candidate per retry."""
        from .join_sampler import EmptyJoinError
        for _ in range(retry_rounds):
            try:
                rows, draws = self.sources[name].draw(self.rng, 1, batch=32)
            except EmptyJoinError:
                break
            self.stats.candidate_draws += draws
            self.stats.residual_rejects += pop_residual_rejects(
                self.sources[name])
            self._since_refresh += 1
            preds = self._own_preds[name]
            if preds and not bool(pred_mask_np(preds, rows)[0]):
                self.stats.pred_rejects += 1
                continue
            if bool(self._cover_accept(oidx, rows)[0]):
                return rows
            self.stats.cover_rejects += 1
        return None

    def _fresh_adaptive(self, name: str, oidx: int,
                        retry_rounds: int) -> Optional[Rows]:
        """EMA-batched fresh draws: ``suggest_batch`` candidates per retry,
        first eligible wins; scanned-prefix reject counts feed the planner."""
        from .join_sampler import EmptyJoinError
        k = self.planner.suggest_batch(oidx)
        preds = self._own_preds[name]
        scanned = accepted_n = pred_total = 0
        out: Optional[Rows] = None
        for _ in range(retry_rounds):
            try:
                rows, draws = self.sources[name].draw(self.rng, k, batch=32)
            except EmptyJoinError:
                break
            self.stats.candidate_draws += draws
            self.stats.residual_rejects += pop_residual_rejects(
                self.sources[name])
            self._since_refresh += 1
            nb = next(iter(rows.values())).shape[0]
            pm = (pred_mask_np(preds, rows) if preds
                  else np.ones(nb, dtype=bool))
            cm = self._cover_accept(oidx, rows)
            elig = np.nonzero(pm & cm)[0]
            stop = int(elig[0]) + 1 if elig.size else nb
            # candidates past the first eligible one are never examined —
            # dropping them whole keeps the emitted tuple a plain uniform
            # draw conditioned on eligibility
            pred_r = int((~pm[:stop]).sum())
            self.stats.pred_rejects += pred_r
            self.stats.cover_rejects += int((pm[:stop] & ~cm[:stop]).sum())
            scanned += stop
            pred_total += pred_r
            if elig.size:
                i = int(elig[0])
                out = {a: rows[a][i:i + 1] for a in self.attrs}
                accepted_n = 1
                break
        if scanned > 0:
            self.planner.observe(oidx, scanned, accepted_n,
                                 pred_rejects=pred_total)
        return out

    # ---------------------------------------------------------------- sample
    def sample(self, n: int, retry_rounds: int = 64) -> SampleSet:
        guard = 0
        max_guard = max(500 * n, 20_000)
        while len(self._accepted) < n:
            guard += 1
            if guard > max_guard:
                raise RuntimeError("OnlineUnionSampler budget exhausted")
            probs = self._selection_probs()
            oidx = int(self.rng.choice(len(self.order), p=probs))
            name = self.order[oidx]
            got = self._try_reuse(name, oidx)
            if got:
                self._accepted.extend(got)
                self._since_refresh += 1
            else:
                # fresh uniform sampling with retry-within-join; under
                # plan="adaptive" each retry draws an EMA-sized batch and
                # accepts the first eligible candidate
                if self.planner is not None:
                    accepted = self._fresh_adaptive(name, oidx, retry_rounds)
                else:
                    accepted = self._fresh_static(name, oidx, retry_rounds)
                if accepted is not None:
                    self._accepted.append(_Accepted(
                        {a: int(accepted[a][0]) for a in self.attrs},
                        oidx, self._sel_ratio(oidx)))
                else:
                    self.stats.dropped_slots += 1
            self.stats.iterations += 1
            if (not self._confident) and self._since_refresh >= self.phi:
                self._since_refresh = 0
                self._refresh_parameters()
        acc = self._accepted[:n]
        self.stats.samples_emitted += n
        rows = {a: np.asarray([s.values[a] for s in acc], dtype=np.int64)
                for a in self.attrs}
        home = np.asarray([s.home for s in acc], dtype=np.int64)
        fp = fingerprint128([rows[a] for a in sorted(self.attrs)])
        return SampleSet(self.attrs, rows, home, fp, self.stats)
