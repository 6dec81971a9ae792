"""§4: k-overlap decomposition (Theorem 3) and union size (Eq. 1).

``A_j^k`` = size of the subset of ``J_j`` shared with exactly ``k-1`` other
joins.  Theorem 3 computes it top-down from overlap sizes ``|O_Δ|``:

    |A_j^n| = |O_S|
    |A_j^k| = Σ_{Δ∈P_k, J_j∈Δ} |O_Δ|  −  Σ_{r=k+1..n} C(r-1, k-1) |A_j^r|
    |A_j^1| = |J_j| − Σ_{r=2..n} |A_j^r|

and Eq. 1 gives  |U| = Σ_j Σ_k (1/k) |A_j^k|.

``OverlapOracle`` abstracts where |O_Δ| comes from (exact / histogram /
random-walk); results are memoised so the bottom-up lattice traversal reuses
shared subsets, as §4 suggests.  With *estimated* overlaps the telescoping can
go slightly negative — we clamp at 0 (documented; estimation noise only
affects sampling efficiency, and ONLINE-UNION's backtracking re-calibrates).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, FrozenSet, List, Sequence


from .joins import JoinSpec


class OverlapOracle:
    """Memoising wrapper around an |O_Δ| estimator and a |J| estimator."""

    def __init__(self,
                 overlap_fn: Callable[[Sequence[JoinSpec]], float],
                 size_fn: Callable[[JoinSpec], float],
                 joins: Sequence[JoinSpec]):
        self.joins = list(joins)
        self.by_name = {j.name: j for j in self.joins}
        self._overlap_fn = overlap_fn
        self._size_fn = size_fn
        self._cache: Dict[FrozenSet[str], float] = {}

    def overlap(self, names: Sequence[str]) -> float:
        key = frozenset(names)
        if len(key) == 1:
            return self.size(next(iter(key)))
        if key not in self._cache:
            delta = [self.by_name[n] for n in sorted(key)]
            self._cache[key] = max(float(self._overlap_fn(delta)), 0.0)
        return self._cache[key]

    def size(self, name: str) -> float:
        key = frozenset([name])
        if key not in self._cache:
            self._cache[key] = max(float(self._size_fn(self.by_name[name])), 0.0)
        return self._cache[key]

    @property
    def calls(self) -> int:
        return len(self._cache)


@dataclasses.dataclass
class KOverlaps:
    names: List[str]
    # a[j][k] = |A_j^k| for k in 1..n (index k-1)
    a: Dict[str, List[float]]

    def union_size(self) -> float:
        """Eq. 1: |U| = Σ_j Σ_k (1/k)·|A_j^k|."""
        total = 0.0
        for name in self.names:
            for k, v in enumerate(self.a[name], start=1):
                total += v / k
        return total


def k_overlaps(oracle: OverlapOracle, clamp: bool = True) -> KOverlaps:
    """Theorem 3 for every join, top-down from k=n to k=1."""
    names = [j.name for j in oracle.joins]
    n = len(names)
    import itertools

    a: Dict[str, List[float]] = {name: [0.0] * n for name in names}
    for name in names:
        others = [m for m in names if m != name]
        # k = n
        a[name][n - 1] = oracle.overlap(names) if n > 1 else oracle.size(name)
        # k = n-1 .. 2
        for k in range(n - 1, 1, -1):
            s = 0.0
            for sub in itertools.combinations(others, k - 1):
                s += oracle.overlap((name,) + sub)
            corr = 0.0
            for r in range(k + 1, n + 1):
                corr += math.comb(r - 1, k - 1) * a[name][r - 1]
            v = s - corr
            a[name][k - 1] = max(v, 0.0) if clamp else v
        # k = 1
        v = oracle.size(name) - sum(a[name][1:])
        a[name][0] = max(v, 0.0) if clamp else v
    return KOverlaps(names, a)
