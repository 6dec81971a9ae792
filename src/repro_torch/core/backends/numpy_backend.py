"""Host (numpy) backend — port copy of ``repro.core.backends.numpy_backend``,
the reference's default engine.

* Candidate draws delegate to :class:`repro_torch.core.join_sampler.
  JoinSampler` (EW/EO batched walks).
* Membership probes delegate to :class:`repro_torch.core.membership.
  MembershipProber` (128-bit fingerprint row-set indexes).

It draws from the caller's ``rng`` in the reference's order with the
reference's batch sizes, so a shared numpy seed reproduces the reference's
host engine exactly.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..index import Catalog
from ..join_sampler import JoinSampler
from ..joins import JoinSpec
from ..membership import MembershipProber
from .base import Backend, Rows


class NumpyCandidateSource:
    """Uniform candidate draws via the host batched-walk sampler."""

    def __init__(self, cat: Catalog, spec: JoinSpec, method: str = "ew"):
        self.join_name = spec.name
        self.sampler = JoinSampler(cat, spec, method=method)
        self._rej_seen = 0

    def draw(self, rng: np.random.Generator, count: int,
             batch: Optional[int] = None) -> Tuple[Rows, int]:
        if batch is None:
            batch = max(count, 64)
        return self.sampler.sample_uniform(rng, count, batch=batch)

    def pop_residual_rejects(self) -> int:
        """Residual (§8.2 cyclic) rejections since the last pop."""
        cur = self.sampler.residual_rejects
        d, self._rej_seen = cur - self._rej_seen, cur
        return d

    def is_empty(self) -> bool:
        return self.sampler.is_empty()


class NumpyBackend(Backend):
    name = "numpy"

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec],
                 join_method: str = "ew", seed: int = 0):
        self.cat = cat
        self.joins = list(joins)
        self._sources: Dict[str, NumpyCandidateSource] = {
            j.name: NumpyCandidateSource(cat, j, method=join_method)
            for j in self.joins
        }
        self._oracle = MembershipProber(cat, self.joins)

    def source(self, join_name: str) -> NumpyCandidateSource:
        return self._sources[join_name]

    def oracle(self) -> MembershipProber:
        return self._oracle
