"""§3.1: cover construction and |J'_i| by inclusion–exclusion.

A cover ``C = {J'_1..J'_n}`` is an ordering of the joins with
``J'_i = J_i \\ ∪_{j<i} J'_j``.  Its sizes come from inclusion–exclusion over
overlap sizes (the paper's Eq. for |J'_i|):

    |J'_i| = |J_i| + Σ_{m=1..i-1} Σ_{Δ⊆S_i, |Δ|=m} (−1)^m |O_{Δ ∪ {J_i}}|

where ``S_i`` = joins before ``J_i``.  ``Σ_i |J'_i|`` is the (estimated)
union size used for the join-selection distribution of Algorithm 1.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Sequence

from .koverlap import OverlapOracle


@dataclasses.dataclass
class Cover:
    order: List[str]                 # join names, cover order
    piece_sizes: Dict[str, float]    # |J'_i| (estimates; >= 0)
    join_sizes: Dict[str, float]     # |J_i| (estimates)

    @property
    def union_size(self) -> float:
        return sum(self.piece_sizes.values())

    def selection_probs(self) -> List[float]:
        u = self.union_size
        if u <= 0:
            return [1.0 / len(self.order)] * len(self.order)
        return [self.piece_sizes[n] / u for n in self.order]


def build_cover(oracle: OverlapOracle, order: Sequence[str] | None = None) -> Cover:
    names = [j.name for j in oracle.joins]
    order = list(order) if order is not None else names
    piece: Dict[str, float] = {}
    for i, name in enumerate(order):
        before = order[:i]
        size = oracle.size(name)
        v = size
        for m in range(1, i + 1):
            sign = -1.0 if m % 2 == 1 else 1.0
            for sub in itertools.combinations(before, m):
                v += sign * oracle.overlap((name,) + sub)
        piece[name] = min(max(v, 0.0), size)
    return Cover(order, piece, {n: oracle.size(n) for n in order})


def largest_first_order(oracle: OverlapOracle) -> List[str]:
    """Heuristic cover order: largest join first (maximises the no-probe piece)."""
    return sorted((j.name for j in oracle.joins),
                  key=lambda n: -oracle.size(n))
