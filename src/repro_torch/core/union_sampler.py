"""§3: the union sampling framework (Algorithm 1 + baselines).

Port of ``repro.core.union_sampler``:

* :class:`DisjointUnionSampler` — Definition 1: pick ``J_j ∝ |J_j|``,
  sample uniformly inside, emit.  No rejection.
* :class:`BernoulliUnionSampler` — the §3 "union trick": per iteration each
  join fires independently with ``P = |J_j|/|U|``; a fired join's sample is
  kept only when the join is the *canonical first* join containing the
  tuple (one membership probe per earlier join through the backend's
  oracle).
* :class:`SetUnionSampler` — Algorithm 1: joins are selected with
  ``P = |J'_j|/|U|`` from a :class:`~repro_torch.core.cover.Cover` and,
  inside the selected join, candidates are drawn until one lands in the
  cover piece ``J'_j``, which makes every emitted sample uniform over the
  union.  ``strict_paper_loop=True`` reproduces the paper's printed
  pseudocode (re-select a join after every rejection; DESIGN.md §7).

Two engines.  ``backend="torch"`` (the default: the card, or the CPU with
``device="cpu"``) runs whole Algorithm-1 rounds on the device
(:class:`~repro_torch.core.backends.torch_backend.TorchUnionSampler`, or
:class:`~repro_torch.core.backends.torch_backend.TorchRecordUnionSampler`
for ``membership="record"``); ``mesh=`` lifts them onto the sharded engine
(:class:`~repro_torch.core.sharding.ShardedUnionSampler`).  ``backend=
"numpy"`` (the reference's default) is the host engine
(:class:`~repro_torch.core.backends.numpy_backend.NumpyBackend`), and runs
the reference's host loops: exact batched probes, or the sequential loop for
record mode and ``strict_paper_loop``.  The baselines draw through the
backend's per-join candidate sources and probe through its oracle, with the
reference's ``numpy.random.default_rng(seed)`` for picks and permutations.

A device backend degrades to the host loops where the reference's does, each
time with a ``repro_engine_fallback_total{reason=...}`` event
(``repro_torch.obs.record_fallback``): ``strict_paper_loop``
(``"strict_paper_loop"``), a §8.3 predicate that does not lower to the
device (``"predicate_unsupported"``), and a backend whose fused rounds are
off because a join left the int32 domain (``TorchBackend.degraded``).  On
a mesh each of these raises instead.  A missing card, a failed kernel build
or launch and a failed graph capture raise; nothing degrades for them.

``SampleSet.rows``, ``home`` and ``fingerprint`` are host numpy arrays
(int64 and uint64), as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..device import mesh_device
from .backends import Backend, get_backend
from .cover import Cover
from .index import Catalog
from .joins import JoinSpec
from .membership import rows_concat, rows_length, rows_subset
from .relation import fingerprint128

Rows = Dict[str, np.ndarray]


@dataclasses.dataclass
class SamplerStats:
    iterations: int = 0
    candidate_draws: int = 0       # ψ of §3.3 (samples obtained from join subroutine)
    cover_rejects: int = 0
    residual_rejects: int = 0      # §8.2 cyclic: walks killed by the Π d/M test
    pred_rejects: int = 0          # §8.3 rejection-mode predicate failures
    canonical_rejects: int = 0
    revisions: int = 0
    dropped_slots: int = 0
    reuse_accepts: int = 0
    reuse_rejects: int = 0
    backtrack_removed: int = 0
    samples_emitted: int = 0       # denominator of psi(): rows handed out
    residual_misses: int = 0       # §8.2 cyclic: skeleton walks whose residual
                                   # probe found no row (d = 0, so Π d/M = 0);
                                   # counted by the fused engine's rounds
    member_lookups: int = 0        # (live candidate, earlier piece) pairs the
                                   # fused engine's rounds looked up

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)

    def psi(self) -> float:
        """ψ of §3.3 as a ratio: candidate draws per emitted sample."""
        if self.samples_emitted <= 0:
            return 0.0
        return self.candidate_draws / self.samples_emitted

    def merge(self, other: "SamplerStats") -> "SamplerStats":
        """Associative in-place merge (counter sum); returns ``self``."""
        for f in dataclasses.fields(self):
            setattr(self, f.name, getattr(self, f.name) + getattr(other, f.name))
        return self

    def snapshot(self) -> "SamplerStats":
        """Point-in-time copy (engines mutate their stats in place)."""
        return dataclasses.replace(self)


@dataclasses.dataclass
class SampleSet:
    """N accepted samples (with-replacement) from the set union."""

    attrs: List[str]
    rows: Rows                      # each (N,)
    home: np.ndarray                # (N,) index of the join the sample credits
    fingerprint: np.ndarray         # (N, 2) uint64
    stats: SamplerStats

    def __len__(self) -> int:
        return int(self.home.shape[0])

    def matrix(self) -> np.ndarray:
        return np.stack([self.rows[a] for a in self.attrs], axis=1)


def _fp_to_int(fp_row: np.ndarray) -> int:
    return (int(fp_row[0]) << 64) | int(fp_row[1])


def pop_residual_rejects(source) -> int:
    """Drain a candidate source's §8.2 residual-rejection counter (0 when the
    source has none)."""
    pop = getattr(source, "pop_residual_rejects", None)
    return int(pop()) if pop is not None else 0


def empty_sample_set(attrs: Sequence[str], stats: SamplerStats) -> SampleSet:
    rows = {a: np.zeros(0, dtype=np.int64) for a in attrs}
    fp = fingerprint128([rows[a] for a in sorted(attrs)])
    return SampleSet(list(attrs), rows, np.zeros(0, dtype=np.int64), fp, stats)


class ReadySample:
    """Resolved async-sample handle (host engines compute eagerly)."""

    def __init__(self, ss: SampleSet):
        self._ss = ss

    def result(self) -> SampleSet:
        return self._ss


def _baseline_sources(backend, joins: Sequence[JoinSpec], uniforms):
    """A baseline sampler's per-join candidate sources.  On a
    ``TorchBackend`` join ``i``'s Philox stream is seeded ``backend.seed +
    i``, or ``uniforms.source(i)`` replaces it."""
    if uniforms is None:
        return [backend.source(j.name) for j in joins]
    return [backend.source(j.name, uniforms=uniforms.source(i))
            for i, j in enumerate(joins)]


class DisjointUnionSampler:
    """Definition 1 — sampling the disjoint union ⨄ J_j.

    ``backend`` is ``"torch"`` (on ``device``: ``None`` means the card and
    raises without one), ``"numpy"`` (the host engine) or a
    :class:`~repro_torch.core.backends.base.Backend` instance, used as it
    is.  ``uniforms`` replaces a ``TorchBackend``'s source streams: an
    object whose ``source(i)`` is join ``i``'s stream."""

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec],
                 join_sizes: Dict[str, float], seed: int = 0,
                 backend: str | Backend = "torch", device=None,
                 uniforms=None, join_method: str = "ew"):
        self.joins = list(joins)
        self.backend = get_backend(backend, cat, self.joins, join_method,
                                   seed, device)
        self.sources = _baseline_sources(self.backend, self.joins, uniforms)
        self.device = getattr(self.backend, "device", None)
        sizes = np.array([max(join_sizes[j.name], 0.0) for j in self.joins])
        total = sizes.sum()
        if not np.isfinite(total) or total <= 0:
            raise ValueError(
                f"DisjointUnionSampler: degenerate join sizes {join_sizes!r} "
                "(all zero/negative or non-finite) — cannot form a selection "
                "distribution")
        self.probs = sizes / total
        self.rng = np.random.default_rng(seed)
        self.attrs = list(self.joins[0].output_attrs)
        self.stats = SamplerStats()

    def sample(self, n: int) -> SampleSet:
        if n <= 0:
            return empty_sample_set(self.attrs, self.stats)
        picks = self.rng.choice(len(self.joins), size=n, p=self.probs)
        parts: List[Rows] = []
        homes: List[np.ndarray] = []
        for j in range(len(self.joins)):
            c = int((picks == j).sum())
            if c == 0:
                continue
            rows, draws = self.sources[j].draw(self.rng, c, batch=1024)
            self.stats.candidate_draws += draws
            self.stats.residual_rejects += pop_residual_rejects(self.sources[j])
            parts.append(rows)
            homes.append(np.full(c, j, dtype=np.int64))
        rows = rows_concat(parts)
        home = np.concatenate(homes)
        perm = self.rng.permutation(n)
        rows = {a: c[perm] for a, c in rows.items()}
        fp = fingerprint128([rows[a] for a in sorted(self.attrs)])
        self.stats.iterations += n
        self.stats.samples_emitted += n
        return SampleSet(self.attrs, rows, home[perm], fp, self.stats)


class BernoulliUnionSampler:
    """§3 union-trick baseline (canonical first-join acceptance).

    The canonical test probes each fired join's candidates against every
    earlier join through the backend's membership oracle (on a
    ``TorchBackend``: ``nj(nj-1)/2`` host→device→host probes per round, as
    in the reference).  Arguments as for :class:`DisjointUnionSampler`, plus
    the union size."""

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec],
                 join_sizes: Dict[str, float], union_size: float,
                 seed: int = 0, backend: str | Backend = "torch",
                 device=None, uniforms=None, join_method: str = "ew"):
        self.cat = cat
        self.joins = list(joins)
        self.backend = get_backend(backend, cat, self.joins, join_method,
                                   seed, device)
        self.sources = _baseline_sources(self.backend, self.joins, uniforms)
        self.device = getattr(self.backend, "device", None)
        self.prober = self.backend.oracle()
        self.sizes = np.array([max(join_sizes[j.name], 1e-12)
                               for j in self.joins])
        self.union_size = max(union_size, self.sizes.max())
        self.rng = np.random.default_rng(seed)
        self.attrs = list(self.joins[0].output_attrs)
        self.stats = SamplerStats()

    def sample(self, n: int, round_size: int = 256,
               max_rounds: int = 100_000) -> SampleSet:
        if n <= 0:
            return empty_sample_set(self.attrs, self.stats)
        acc_rows: List[Rows] = []
        acc_home: List[int] = []
        names = [j.name for j in self.joins]
        p_fire = np.minimum(self.sizes / self.union_size, 1.0)
        count = 0
        for _ in range(max_rounds):
            if count >= n:
                break
            self.stats.iterations += round_size
            # Bernoulli fire matrix (round, joins)
            fires = self.rng.random((round_size, len(self.joins))) < p_fire[None, :]
            for j, name in enumerate(names):
                c = int(fires[:, j].sum())
                if c == 0:
                    continue
                rows, draws = self.sources[j].draw(self.rng, c, batch=1024)
                self.stats.candidate_draws += draws
                self.stats.residual_rejects += pop_residual_rejects(
                    self.sources[j])
                # canonical acceptance: no earlier-indexed join contains it
                keep = np.ones(c, dtype=bool)
                for i in range(j):
                    keep &= ~self.prober.contains(names[i], rows)
                self.stats.canonical_rejects += int((~keep).sum())
                kidx = np.nonzero(keep)[0]
                if kidx.shape[0]:
                    acc_rows.append(rows_subset(rows, kidx))
                    acc_home.extend([j] * kidx.shape[0])
                    count += kidx.shape[0]
        if count < n:
            raise RuntimeError("BernoulliUnionSampler: round budget exhausted")
        rows = {a: c[:n] for a, c in rows_concat(acc_rows).items()}
        home = np.asarray(acc_home[:n], dtype=np.int64)
        fp = fingerprint128([rows[a] for a in sorted(self.attrs)])
        self.stats.samples_emitted += n
        return SampleSet(self.attrs, rows, home, fp, self.stats)


class SetUnionSampler:
    """Algorithm 1 — non-Bernoulli cover-based set-union sampling.

    ``backend`` is ``"torch"`` (the default; ``device=None`` means the card
    and raises without one, ``device="cpu"`` runs the plain PyTorch path),
    ``"numpy"`` (the host engine) or a ``Backend`` instance, used as it is.
    On a backend with fused rounds the rounds run on the device engine; the
    host loops run otherwise, and where the module docstring's degrade
    cases apply.

    Device engine: ``round_batch=None`` consults the port's
    ``planner.PLAN_CACHE`` (fed by this process's timed calls) and falls
    back to 4096 while it is cold.  ``uniforms`` replaces the device Philox
    stream (tests replay the reference's uniforms through it).  ``mesh=``
    runs the sharded engine on the mesh's rank and device (``round_batch``
    is then per rank); ``device`` must then be left out or name the mesh's
    device type.  ``fused_rounds`` picks the round loop: ``"device"`` (the
    default, with or without ``mesh=``) replays one CUDA graph of a round per
    capacity class on the card (at world 1; at world > 1 the round runs
    eagerly) with one host sync per chunk of rounds; ``"host"`` syncs after
    every round.  Record mode is host-driven in either mode.
    ``dead_rounds``, ``max_rounds``, ``balance`` and ``balance_slack`` are
    the reference engine's, with its defaults.

    Host loops: ``join_method`` (``"ew"``, ``"eo"``; the numpy backend
    only: the device backend records ``"join_method"`` and raises),
    ``retry_rounds`` (draw attempts per piece before it is dropped) and
    ``candidate_batch`` (candidates drawn per missing row) are the
    reference's, with its defaults; they draw from
    ``numpy.random.default_rng(seed)`` as the reference does."""

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec], cover: Cover,
                 seed: int = 0, backend: str | Backend = "torch",
                 device=None, round_batch: Optional[int] = 4096,
                 uniforms=None, membership: str = "probe", predicate=None,
                 plan: str = "static", mesh=None,
                 fused_rounds: Optional[str] = None, dead_rounds: int = 8,
                 max_rounds: int = 4096, balance: str = "cover",
                 balance_slack: float = 1.5, join_method: str = "ew",
                 strict_paper_loop: bool = False, retry_rounds: int = 64,
                 candidate_batch: int = 32):
        from .. import obs
        if membership not in ("probe", "record"):
            raise ValueError("membership must be 'probe' or 'record'")
        if plan not in ("static", "adaptive"):
            raise ValueError("plan must be 'static' or 'adaptive', got "
                             f"{plan!r}")
        if mesh is not None and membership == "record":
            raise ValueError(
                "membership='record' is not supported on the sharded "
                "engine (the record multiset is device-global); drop "
                "mesh= or use membership='probe'")
        device = mesh_device(mesh, device)
        self.cat = cat
        self.joins = list(joins)
        self.by_name = {j.name: j for j in self.joins}
        self.cover = cover
        self.order = list(cover.order)
        self.attrs = list(self.joins[0].output_attrs)
        self.membership = membership
        self.strict_paper_loop = strict_paper_loop
        self.plan = plan
        self.predicate = predicate
        self.retry_rounds = retry_rounds
        self.candidate_batch = candidate_batch
        self.rng = np.random.default_rng(seed)
        self.stats = SamplerStats()
        # record mode state of the host loop: fingerprint -> home order-index
        self._record: Dict[int, int] = {}
        self._prober = None
        self.backend = get_backend(backend, cat, self.joins, join_method,
                                   seed, device)
        self.device = getattr(self.backend, "device", None)
        fused = self.backend.supports_fused_rounds()
        if mesh is not None and not fused:
            raise ValueError("mesh= requires a fused-round backend; use "
                             "backend='torch' (and no join out of the int32 "
                             "domain)")
        if fused and strict_paper_loop:
            # host-only ablation (re-selects a join after every rejection:
            # sequential); degrade rather than refuse
            if mesh is not None:
                raise ValueError("strict_paper_loop is a host-only ablation; "
                                 "it cannot run on a mesh")
            obs.record_fallback("strict_paper_loop",
                                detail="host-only ablation loop")
            fused = False
        if fused and (predicate is not None
                      or any(j.reject_preds for j in self.joins)):
            # §8.3 rejection predicates lower to in-round masks when the
            # comparisons are device-supported; otherwise the whole union
            # degrades to the host loop
            from .predicates import device_lower_reason
            reason = None
            for j in self.joins:
                preds = list(j.reject_preds)
                if predicate is not None:
                    preds += list(predicate.preds)
                reason = device_lower_reason(preds, j.output_attrs)
                if reason is not None:
                    break
            if reason is not None:
                if mesh is not None:
                    raise ValueError(
                        f"predicate not device-lowerable ({reason}); drop "
                        "mesh= to fall back to the host engine")
                obs.record_fallback("predicate_unsupported", detail=reason,
                                    join=j.name)
                fused = False
        self.engine = None
        self.autotuned_plan = None
        if not fused:
            self.sources = {j.name: self.backend.source(j.name)
                            for j in self.joins}
            return
        # round_batch=None: the autotuning cost model, 4096 while cold
        surplus_cap = None
        if round_batch is None:
            from . import planner
            self.autotuned_plan = planner.PLAN_CACHE.suggest(
                planner.plan_key(cat, self.joins, cover))
            if self.autotuned_plan is not None:
                round_batch = self.autotuned_plan.round_batch
                surplus_cap = self.autotuned_plan.surplus_cap
            else:
                round_batch = 4096
        kw = dict(seed=seed, round_batch=round_batch, stats=self.stats,
                  uniforms=uniforms, predicate=predicate, plan=plan,
                  surplus_cap=surplus_cap, dead_rounds=dead_rounds,
                  max_rounds=max_rounds, balance=balance,
                  balance_slack=balance_slack)
        if fused_rounds is not None:
            kw["fused_rounds"] = fused_rounds
        if mesh is not None:
            from .sharding import ShardedCatalog, ShardedUnionSampler
            scat = ShardedCatalog(cat, self.joins, mesh=mesh,
                                  backend=self.backend)
            self.engine = ShardedUnionSampler(scat, cover, **kw)
            return
        from .backends.torch_backend import (TorchRecordUnionSampler,
                                             TorchUnionSampler)
        engine = (TorchRecordUnionSampler if membership == "record"
                  else TorchUnionSampler)
        self.engine = engine(self.backend, cover, **kw)

    # ------------------------------------------------------------------ util
    @property
    def prober(self):
        if self._prober is None:
            self._prober = self.backend.oracle()
        return self._prober

    def _selection_probs(self) -> np.ndarray:
        p = np.asarray(self.cover.selection_probs(), dtype=np.float64)
        p = np.maximum(p, 0)
        s = p.sum()
        return p / s if s > 0 else np.full(len(p), 1.0 / len(p))

    def _uniform_candidates(self, name: str, count: int) -> Optional[Rows]:
        from .join_sampler import EmptyJoinError
        try:
            rows, draws = self.sources[name].draw(self.rng, count,
                                                  batch=max(count, 64))
        except EmptyJoinError:
            # the estimate gave a positive piece size to an empty join —
            # treat the slots as dropped
            return None
        self.stats.candidate_draws += draws
        self.stats.residual_rejects += pop_residual_rejects(self.sources[name])
        return rows

    def _cover_accept_probe(self, oidx: int, rows: Rows) -> np.ndarray:
        """accept iff no earlier join in cover order contains the tuple."""
        keep = np.ones(rows_length(rows), dtype=bool)
        for i in range(oidx):
            if not keep.any():
                break
            keep &= ~self.prober.contains(self.order[i], rows)
        return keep

    def _pred_ok(self, name: str, rows: Rows) -> Optional[np.ndarray]:
        """§8.3 own-join predicate mask (per-join ``reject_preds`` AND the
        union-wide ``predicate=``), or ``None`` when there is none."""
        from .predicates import pred_mask_np
        spec = self.by_name[name]
        mask = None
        if spec.reject_preds:
            mask = pred_mask_np(spec.reject_preds, rows)
        if self.predicate is not None:
            m = self.predicate.accept(rows)
            mask = m if mask is None else mask & m
        return mask

    # --------------------------------------------------------------- sampling
    def sample(self, n: int) -> SampleSet:
        if n <= 0:
            return empty_sample_set(self.attrs, self.stats)
        if self.engine is not None:
            return self.engine.sample(n)
        if self.membership == "probe" and not self.strict_paper_loop:
            return self._sample_probe(n)
        return self._sample_sequential(n)

    def sample_async(self, n: int):
        """Launch ``sample(n)``'s rounds; ``result()`` on the returned
        handle finishes them and does the device→host fetch (host loops
        return a resolved handle)."""
        if self.engine is not None:
            return self.engine.sample_async(n)
        return ReadySample(self.sample(n))

    # -- exact mode: batched, stateless, provably uniform ---------------------
    def _sample_probe(self, n: int) -> SampleSet:
        acc_rows: List[Rows] = []
        acc_home: List[np.ndarray] = []
        total = 0
        topups = 0
        target = n
        dead_pieces: set = set()
        while total < n:
            probs = self._selection_probs()
            for oidx in dead_pieces:
                probs[oidx] = 0.0
            if probs.sum() <= 0:
                raise RuntimeError("all cover pieces unreachable")
            probs = probs / probs.sum()
            need_by_join = self.rng.multinomial(target, probs)
            for oidx, name in enumerate(self.order):
                need = int(need_by_join[oidx])
                got = 0
                rounds = 0
                while got < need:
                    rounds += 1
                    if rounds > self.retry_rounds:
                        self.stats.dropped_slots += need - got
                        dead_pieces.add(oidx)
                        break
                    want = max((need - got) * self.candidate_batch, 64)
                    rows = self._uniform_candidates(name, want)
                    if rows is None:
                        self.stats.dropped_slots += need - got
                        dead_pieces.add(oidx)
                        break
                    pred_ok = self._pred_ok(name, rows)
                    if pred_ok is None:
                        pred_ok = np.ones(rows_length(rows), dtype=bool)
                    else:
                        self.stats.pred_rejects += int((~pred_ok).sum())
                    cover_ok = self._cover_accept_probe(oidx, rows)
                    # cover_rejects counts candidates that pass the predicate
                    # but land outside the piece (the device round's split)
                    self.stats.cover_rejects += int((pred_ok & ~cover_ok).sum())
                    keep = pred_ok & cover_ok
                    kidx = np.nonzero(keep)[0][: need - got]
                    self.stats.iterations += want
                    if kidx.shape[0]:
                        acc_rows.append(rows_subset(rows, kidx))
                        acc_home.append(np.full(kidx.shape[0], oidx,
                                                dtype=np.int64))
                        got += int(kidx.shape[0])
                total += got
            target = n - total
            topups += 1
            if topups > 64 and total < n:
                raise RuntimeError("SetUnionSampler: top-up budget exhausted")
        rows = {a: c[:n] for a, c in rows_concat(acc_rows).items()}
        home = np.concatenate(acc_home)[:n]
        perm = self.rng.permutation(home.shape[0])
        rows = {a: c[perm] for a, c in rows.items()}
        fp = fingerprint128([rows[a] for a in sorted(self.attrs)])
        self.stats.samples_emitted += n
        return SampleSet(self.attrs, rows, home[perm], fp, self.stats)

    # -- record mode / strict paper loop: sequential Algorithm 1 --------------
    def _sample_sequential(self, n: int) -> SampleSet:
        probs = self._selection_probs()
        out_rows: List[Dict[str, int]] = []
        out_home: List[int] = []
        out_fp: List[int] = []
        guard = 0
        max_guard = max(200 * n, 10_000)
        while len(out_rows) < n:
            guard += 1
            if guard > max_guard:
                raise RuntimeError("Algorithm 1 budget exhausted (check "
                                   "parameters)")
            oidx = int(self.rng.choice(len(self.order), p=probs))
            name = self.order[oidx]
            accepted = None
            inner = self.retry_rounds if not self.strict_paper_loop else 1
            for _ in range(inner):
                rows = self._uniform_candidates(name, 1)
                if rows is None:
                    self.stats.dropped_slots += 1
                    break
                self.stats.iterations += 1
                fp2 = fingerprint128([rows[a] for a in sorted(self.attrs)])[0]
                fpi = _fp_to_int(fp2)
                pred_ok = self._pred_ok(name, rows)
                if pred_ok is not None and not bool(pred_ok[0]):
                    self.stats.pred_rejects += 1
                    continue
                if self.membership == "probe":
                    if bool(self._cover_accept_probe(oidx, rows)[0]):
                        accepted = (rows, fpi)
                        break
                    self.stats.cover_rejects += 1
                else:
                    home = self._record.get(fpi)
                    if home is not None and home < oidx:
                        self.stats.cover_rejects += 1
                        continue  # Alg 1 line 8: reject
                    if home is not None and home > oidx:
                        # Alg 1 lines 10-12: revision
                        self.stats.revisions += 1
                        removed = [k for k, f in enumerate(out_fp) if f == fpi]
                        for k in reversed(removed):
                            out_rows.pop(k)
                            out_home.pop(k)
                            out_fp.pop(k)
                        self.stats.backtrack_removed += len(removed)
                    self._record[fpi] = oidx
                    accepted = (rows, fpi)
                    break
            if accepted is None:
                continue
            rows, fpi = accepted
            out_rows.append({a: int(rows[a][0]) for a in self.attrs})
            out_home.append(oidx)
            out_fp.append(fpi)
        rows = {a: np.asarray([r[a] for r in out_rows[:n]], dtype=np.int64)
                for a in self.attrs}
        home = np.asarray(out_home[:n], dtype=np.int64)
        fp = fingerprint128([rows[a] for a in sorted(self.attrs)])
        self.stats.samples_emitted += n
        return SampleSet(self.attrs, rows, home, fp, self.stats)
