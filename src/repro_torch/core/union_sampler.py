"""§3: Algorithm 1 — cover-based set-union sampling on the card.

Port of ``repro.core.union_sampler`` for the device engine:
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

``SampleSet.rows``, ``home`` and ``fingerprint`` are host numpy arrays
(int64 and uint64) after the one device→host copy per ``sample(n)``, as in
the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

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


class SetUnionSampler:
    """Algorithm 1 — non-Bernoulli cover-based set-union sampling.

    ``backend="torch"`` is the only engine of the port; ``device=None``
    means the card and raises without one (pass ``device="cpu"`` for the
    plain PyTorch path).  ``round_batch=None`` consults the port's
    ``planner.PLAN_CACHE`` (fed by this process's timed calls) and falls
    back to 4096 while it is cold.  ``uniforms`` replaces the device Philox
    stream (tests replay the reference's uniforms through it)."""

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec], cover: Cover,
                 seed: int = 0, backend: str = "torch", device=None,
                 round_batch: Optional[int] = 4096, uniforms=None,
                 membership: str = "probe", predicate=None,
                 plan: str = "static"):
        from .backends.torch_backend import (TorchBackend,
                                             TorchRecordUnionSampler,
                                             TorchUnionSampler)
        if backend != "torch":
            raise ValueError(f"repro_torch runs backend='torch' only, got "
                             f"{backend!r}")
        if membership not in ("probe", "record"):
            raise ValueError("membership must be 'probe' or 'record'")
        if plan not in ("static", "adaptive"):
            raise ValueError("plan must be 'static' or 'adaptive', got "
                             f"{plan!r}")
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
        self.backend = TorchBackend(cat, self.joins, device=device)
        self.device = self.backend.device
        self.stats = SamplerStats()
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
