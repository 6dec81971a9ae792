"""Backend contracts of the union sampling engine.

Port copy of ``repro.core.backends.base``.  Algorithm 1 consumes two
primitives, and every backend supplies the same pair:

* :class:`CandidateSource` — batched uniform candidate draws from one join
  (§3.2's sampling subroutine);
* :class:`MembershipOracle` — batched "is tuple ``t`` in join ``J``?"
  probes (the cover-acceptance test of §3.1).

A :class:`Backend` bundles one source per join and one oracle over all of
them.  The host loops of :class:`repro_torch.core.union_sampler.
SetUnionSampler`, the baselines and :mod:`repro_torch.core.online` are
written against these protocols only.  The port has two backends:
``"numpy"`` (:class:`~repro_torch.core.backends.numpy_backend.
NumpyBackend`, the reference's default host engine) and ``"torch"``
(:class:`~repro_torch.core.backends.torch_backend.TorchBackend`, the card's
engine, which also runs whole Algorithm-1 rounds: callers feature-test with
:meth:`Backend.supports_fused_rounds`).

Sources may expose ``pop_residual_rejects() -> int`` (a drain-style counter
of §8.2 residual rejections); the samplers fold it into
``SamplerStats.residual_rejects`` after every ``draw``.
"""

from __future__ import annotations

from typing import Dict, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

Rows = Dict[str, np.ndarray]


@runtime_checkable
class CandidateSource(Protocol):
    """Uniform candidate draws from a single join.

    ``draw`` returns ``(rows, draws)``: ``count`` uniform-with-replacement
    samples of the join's output tuples plus the number of candidate walks
    spent obtaining them (ψ of §3.3).  Implementations raise
    :class:`repro_torch.core.join_sampler.EmptyJoinError` when the join is
    structurally empty.  ``rng`` is the host generator; a device source
    with a stream of its own ignores it (and ``batch``).
    """

    join_name: str

    def draw(self, rng: np.random.Generator, count: int,
             batch: Optional[int] = None) -> Tuple[Rows, int]:
        ...

    def is_empty(self) -> bool:
        ...


@runtime_checkable
class MembershipOracle(Protocol):
    """Batched membership probes against the joins of one union."""

    def contains(self, join_name: str, rows: Rows) -> np.ndarray:
        """Boolean vector: does ``join_name`` contain each tuple of ``rows``?"""
        ...

    def membership_matrix(self, rows: Rows,
                          join_names: Optional[Sequence[str]] = None
                          ) -> np.ndarray:
        """(n_tuples, n_joins) boolean membership matrix."""
        ...


class Backend:
    """One candidate source per join + one membership oracle over the union."""

    name: str = "abstract"

    def source(self, join_name: str) -> CandidateSource:
        raise NotImplementedError

    def oracle(self) -> MembershipOracle:
        raise NotImplementedError

    def supports_fused_rounds(self) -> bool:
        """True when the backend can run a whole Algorithm-1 round on device."""
        return False
