"""§3: the union sampling framework on the card (Algorithm 1 + baselines).

Port of ``repro.core.union_sampler`` for the device engine:

* :class:`DisjointUnionSampler` — Definition 1: pick ``J_j ∝ |J_j|``,
  sample uniformly inside, emit.  No rejection.
* :class:`BernoulliUnionSampler` — the §3 "union trick": per iteration each
  join fires independently with ``P = |J_j|/|U|``; a fired join's sample is
  kept only when the join is the *canonical first* join containing the
  tuple (one membership probe per earlier join through the backend's
  oracle).

Both take their candidates from the backend's per-join
:class:`~repro_torch.core.backends.torch_backend.TorchCandidateSource` and
their picks, permutation and fire matrix from the reference's
``numpy.random.default_rng(seed)``.

:class:`SetUnionSampler` selects joins with ``P = |J'_j|/|U|`` from a
:class:`~repro_torch.core.cover.Cover` and, inside the selected join, draws
until the candidate lands in the cover piece ``J'_j``, which makes every
emitted sample uniform over the union.  Two cover-membership modes:

- ``membership="probe"`` — exact batched membership probes against the
  earlier joins (:class:`~repro_torch.core.backends.torch_backend.
  TorchUnionSampler`), with ``plan="static"`` or ``plan="adaptive"``;
- ``membership="record"`` — the paper's lazy ``orig_join`` record with
  revision (:class:`~repro_torch.core.backends.torch_backend.
  TorchRecordUnionSampler`), ``plan="static"`` only.

§8.3 predicates run in the round: ``pushdown()`` provenance becomes
build-time validity masks, rejection predicates (union-wide ``predicate=``
or per-join ``JoinSpec.reject_preds``) in-round acceptance masks.  The port
has no host engine: predicates that cannot lower to the device raise.

``mesh=`` (a :func:`~repro_torch.core.sharding.make_sampler_mesh` mesh)
runs the rounds on the sharded engine
(:class:`~repro_torch.core.sharding.ShardedUnionSampler`: per-rank draws,
hash-partitioned membership, one fingerprint exchange per round); a world
of one reproduces the unsharded engine bit for bit.

``SampleSet.rows``, ``home`` and ``fingerprint`` are host numpy arrays
(int64 and uint64) after the one device→host copy per ``sample(n)``, as in
the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..device import mesh_device
from .cover import Cover
from .index import Catalog
from .joins import JoinSpec
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


def empty_sample_set(attrs: Sequence[str], stats: SamplerStats) -> SampleSet:
    rows = {a: np.zeros(0, dtype=np.int64) for a in attrs}
    fp = fingerprint128([rows[a] for a in sorted(attrs)])
    return SampleSet(list(attrs), rows, np.zeros(0, dtype=np.int64), fp, stats)


def _concat(parts: List[Rows], attrs: Sequence[str]) -> Rows:
    return {a: np.concatenate([p[a] for p in parts]) for a in attrs}


def get_backend(backend, cat: Catalog, joins: Sequence[JoinSpec], device,
                seed: int = 0):
    """``"torch"`` builds a :class:`~repro_torch.core.backends.
    torch_backend.TorchBackend` on ``device``; a ``TorchBackend`` instance
    is used as it is (its device and source seeds hold), as the reference's
    ``get_backend`` does with a ``Backend``."""
    from .backends.torch_backend import TorchBackend
    if isinstance(backend, TorchBackend):
        return backend
    if backend != "torch":
        raise ValueError(f"repro_torch runs backend='torch' only, got "
                         f"{backend!r}")
    return TorchBackend(cat, joins, device=device, seed=seed)


def _baseline_sources(backend, joins: Sequence[JoinSpec], uniforms):
    """A baseline sampler's per-join candidate sources: join ``i``'s Philox
    stream is seeded ``backend.seed + i``, or ``uniforms.source(i)``
    replaces it."""
    return [backend.source(j.name, uniforms=None if uniforms is None
                           else uniforms.source(i))
            for i, j in enumerate(joins)]


class DisjointUnionSampler:
    """Definition 1 — sampling the disjoint union ⨄ J_j.

    ``backend="torch"`` (or a ``TorchBackend``, see :func:`get_backend`)
    is the port's one engine; ``device=None`` means the card and raises
    without one.  ``uniforms`` replaces the sources' Philox streams: an
    object whose ``source(i)`` is join ``i``'s stream."""

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec],
                 join_sizes: Dict[str, float], seed: int = 0,
                 backend="torch", device=None, uniforms=None):
        self.joins = list(joins)
        self.backend = get_backend(backend, cat, self.joins, device, seed)
        self.sources = _baseline_sources(self.backend, self.joins, uniforms)
        self.device = self.backend.device
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
            rows, draws = self.sources[j].draw(c)
            self.stats.candidate_draws += draws
            self.stats.residual_rejects += self.sources[j].pop_residual_rejects()
            parts.append(rows)
            homes.append(np.full(c, j, dtype=np.int64))
        rows = _concat(parts, self.attrs)
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
    earlier join through the backend's membership oracle: ``nj(nj-1)/2``
    host→device→host probes per round, as in the reference.  Arguments as
    for :class:`DisjointUnionSampler`, plus the union size."""

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec],
                 join_sizes: Dict[str, float], union_size: float,
                 seed: int = 0, backend="torch", device=None,
                 uniforms=None):
        self.cat = cat
        self.joins = list(joins)
        self.backend = get_backend(backend, cat, self.joins, device, seed)
        self.sources = _baseline_sources(self.backend, self.joins, uniforms)
        self.device = self.backend.device
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
                rows, draws = self.sources[j].draw(c)
                self.stats.candidate_draws += draws
                self.stats.residual_rejects += \
                    self.sources[j].pop_residual_rejects()
                # canonical acceptance: no earlier-indexed join contains it
                keep = np.ones(c, dtype=bool)
                for i in range(j):
                    keep &= ~self.prober.contains(names[i], rows)
                self.stats.canonical_rejects += int((~keep).sum())
                kidx = np.nonzero(keep)[0]
                if kidx.shape[0]:
                    acc_rows.append({a: v[kidx] for a, v in rows.items()})
                    acc_home.extend([j] * kidx.shape[0])
                    count += kidx.shape[0]
        if count < n:
            raise RuntimeError("BernoulliUnionSampler: round budget exhausted")
        rows = {a: c[:n] for a, c in _concat(acc_rows, self.attrs).items()}
        home = np.asarray(acc_home[:n], dtype=np.int64)
        fp = fingerprint128([rows[a] for a in sorted(self.attrs)])
        self.stats.samples_emitted += n
        return SampleSet(self.attrs, rows, home, fp, self.stats)


class SetUnionSampler:
    """Algorithm 1 — non-Bernoulli cover-based set-union sampling.

    ``backend="torch"`` (or a ``TorchBackend``, see :func:`get_backend`)
    is the only engine of the port; ``device=None``
    means the card and raises without one (pass ``device="cpu"`` for the
    plain PyTorch path).  ``round_batch=None`` consults the port's
    ``planner.PLAN_CACHE`` (fed by this process's timed calls) and falls
    back to 4096 while it is cold.  ``uniforms`` replaces the device Philox
    stream (tests replay the reference's uniforms through it).  ``mesh=``
    runs the sharded engine on the mesh's rank and device (``round_batch``
    is then per rank); ``device`` must then be left out or name the mesh's
    device type."""

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec], cover: Cover,
                 seed: int = 0, backend="torch", device=None,
                 round_batch: Optional[int] = 4096, uniforms=None,
                 membership: str = "probe", predicate=None,
                 plan: str = "static", mesh=None):
        from .backends.torch_backend import (TorchRecordUnionSampler,
                                             TorchUnionSampler)
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
        self.cover = cover
        self.order = list(cover.order)
        self.attrs = list(self.joins[0].output_attrs)
        self.membership = membership
        self.plan = plan
        self.predicate = predicate
        # §8.3 rejection predicates must lower to in-round masks: the
        # reference degrades the union to its host engine otherwise; the
        # port has none and refuses
        from .predicates import device_lower_reason
        for j in self.joins:
            preds = list(j.reject_preds)
            if predicate is not None:
                preds += list(predicate.preds)
            reason = device_lower_reason(preds, j.output_attrs)
            if reason is not None:
                raise ValueError(
                    f"predicate not device-lowerable ({reason}) in join "
                    f"{j.name!r}; the port has no host engine to run it")
        # round_batch=None: the autotuning cost model, 4096 while cold
        self.autotuned_plan = None
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
        self.backend = get_backend(backend, cat, self.joins, device)
        self.device = self.backend.device
        self.stats = SamplerStats()
        if mesh is not None:
            from .sharding import ShardedCatalog, ShardedUnionSampler
            scat = ShardedCatalog(cat, self.joins, mesh=mesh,
                                  backend=self.backend)
            self.engine = ShardedUnionSampler(
                scat, cover, seed=seed, round_batch=round_batch,
                stats=self.stats, uniforms=uniforms, predicate=predicate,
                plan=plan, surplus_cap=surplus_cap)
            return
        engine = (TorchRecordUnionSampler if membership == "record"
                  else TorchUnionSampler)
        self.engine = engine(
            self.backend, cover, seed=seed, round_batch=round_batch,
            stats=self.stats, uniforms=uniforms, predicate=predicate,
            plan=plan, surplus_cap=surplus_cap)

    @property
    def prober(self):
        return self.backend.oracle()

    def sample(self, n: int) -> SampleSet:
        if n <= 0:
            return empty_sample_set(self.attrs, self.stats)
        return self.engine.sample(n)

    def sample_async(self, n: int):
        """Run ``sample(n)``'s rounds; ``result()`` on the returned handle
        does the device→host fetch."""
        return self.engine.sample_async(n)
