"""§3: Algorithm 1 — cover-based set-union sampling on the card.

Port of ``repro.core.union_sampler`` for the device engine of this slice:
:class:`SetUnionSampler` selects joins with ``P = |J'_j|/|U|`` from a
:class:`~repro_torch.core.cover.Cover` and, inside the selected join, draws
until the candidate lands in the cover piece ``J'_j`` (probe membership
against the earlier pieces), which makes every emitted sample uniform over
the union.  All of it runs in
:class:`~repro_torch.core.backends.torch_backend.TorchUnionSampler`.

``SampleSet.rows``, ``home`` and ``fingerprint`` are host numpy arrays
(int64 and uint64) after the one device→host copy per ``sample(n)``, as in
the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

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
    plain PyTorch path).  ``uniforms`` replaces the device Philox stream
    (tests replay the reference's uniforms through it)."""

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec], cover: Cover,
                 seed: int = 0, backend: str = "torch", device=None,
                 round_batch: int = 4096, uniforms=None):
        from .backends.torch_backend import TorchBackend, TorchUnionSampler
        if backend != "torch":
            raise ValueError(f"repro_torch runs backend='torch' only, got "
                             f"{backend!r}")
        self.cat = cat
        self.joins = list(joins)
        self.cover = cover
        self.order = list(cover.order)
        self.attrs = list(self.joins[0].output_attrs)
        self.backend = TorchBackend(cat, self.joins, device=device)
        self.device = self.backend.device
        self.stats = SamplerStats()
        self.engine = TorchUnionSampler(
            self.backend, cover, seed=seed, round_batch=round_batch,
            stats=self.stats, uniforms=uniforms)

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
