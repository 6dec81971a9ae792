"""Join-size estimation (§3.2 bound + §6.1 wander-join Horvitz–Thompson).

Port copy of ``repro.core.size_estimation``:

* :func:`olken_bound` — the extended Olken upper bound
  ``|J| <= |R_1| * prod_i M_{A_i}(R_{i+1})`` generalised to trees and cyclic
  joins as the product of per-edge max degrees, scaled by the estimated
  selectivity of a join's §8.3 rejection predicates.
* :class:`RunningMean` — the paper's streaming update
  ``|J|_{S∪t0} = |J|_S + ( 1/p(t0) - |J|_S ) / (m+1)`` (Welford) with the
  CLT half-width ``z_alpha * sigma / sqrt(m)``.
* :class:`WanderJoinSizeEstimator` — batched wander-join walks on the card
  (:class:`~repro_torch.core.estimators.torch_estimator.TorchEstimator`)
  give i.i.d. ``1/p(t)`` draws whose mean is ``|J|``; failed walks are
  observations of zero.  Stops when the half-width falls below a threshold.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from .index import Catalog
from .joins import JoinSpec

Z_TABLE = {0.80: 1.2816, 0.90: 1.6449, 0.95: 1.9600, 0.99: 2.5758}


def z_value(confidence: float) -> float:
    if confidence in Z_TABLE:
        return Z_TABLE[confidence]
    # rational approximation (Beasley–Springer/Moro would be overkill here)
    from math import sqrt, log
    p = 1.0 - (1.0 - confidence) / 2.0
    # Acklam-lite inverse normal CDF
    t = sqrt(-2.0 * log(1.0 - p))
    return t - (2.30753 + 0.27061 * t) / (1.0 + 0.99229 * t + 0.04481 * t * t)


def olken_bound(cat: Catalog, spec: JoinSpec) -> float:
    """Extended Olken upper bound on |J|.

    Joins carrying §8.3 rejection predicates are scaled by the estimated
    predicate selectivity — the bound must describe the *filtered* join the
    sampler targets (see predicates.selectivity_factor)."""
    order = spec.expansion_order()
    b = float(order[0].relation.nrows)
    for n in order[1:]:
        idx = cat.index(n.relation, list(n.edge_attrs))
        b *= max(idx.max_degree(), 0)
    if spec.reject_preds:
        from .predicates import selectivity_factor
        b *= selectivity_factor(spec)
    return b


@dataclasses.dataclass
class RunningMean:
    """Streaming mean/variance (Welford) — the paper's online update rule."""

    count: int = 0
    mean: float = 0.0
    m2: float = 0.0

    def update(self, x: float) -> None:
        self.count += 1
        d = x - self.mean
        self.mean += d / self.count          # == paper's |J|_{S∪t0} update
        self.m2 += d * (x - self.mean)

    def update_batch(self, xs: np.ndarray) -> None:
        for x in np.asarray(xs, dtype=np.float64).ravel():
            self.update(float(x))

    def merge(self, other: "RunningMean") -> "RunningMean":
        """Associative merge (Chan et al.) — used by the distributed
        sampler's all-gather (:func:`repro_torch.core.distributed.
        merge_statistics`)."""
        if other.count == 0:
            return self
        if self.count == 0:
            self.count, self.mean, self.m2 = other.count, other.mean, other.m2
            return self
        n = self.count + other.count
        d = other.mean - self.mean
        self.mean += d * other.count / n
        self.m2 += other.m2 + d * d * self.count * other.count / n
        self.count = n
        return self

    @property
    def variance(self) -> float:
        return self.m2 / (self.count - 1) if self.count > 1 else 0.0

    def half_width(self, confidence: float = 0.90) -> float:
        if self.count < 2:
            return math.inf
        return z_value(confidence) * math.sqrt(self.variance / self.count)


class WanderJoinSizeEstimator:
    """HT estimate of |J| from batched wander-join walks, with CI stopping.

    ``backend="torch"`` is the port's one engine: the walk batches and the HT
    accumulation run on ``device`` (``None`` means the card; pass
    ``device="cpu"`` for the plain PyTorch path).  ``uniforms`` replaces the
    device Philox walk stream (tests replay the reference's through it)."""

    def __init__(self, cat: Catalog, spec: JoinSpec, seed: int = 0,
                 batch: int = 512, backend: str = "torch", device=None,
                 uniforms=None):
        if backend != "torch":
            raise ValueError(f"unknown backend {backend!r} (repro_torch runs "
                             "backend='torch' only)")
        from .estimators.torch_estimator import TorchEstimator
        self.spec = spec
        self.batch = batch
        self.walks = 0
        self._est = TorchEstimator(cat, [spec], seed=seed, batch=batch,
                                   device=device, uniforms=uniforms)
        self._est.observe([spec], rounds=0)      # materialise the accumulator
        self.stat = self._est.size_stats[spec.name]

    def step(self) -> Tuple[float, float]:
        """One batch of walks; returns (estimate, half_width@90%)."""
        self._est.observe([self.spec], rounds=1)
        self.stat = self._est.size_stats[self.spec.name]
        self.walks += self.batch
        return self.stat.mean, self.stat.half_width(0.90)

    def run(self, confidence: float = 0.90, rel_halfwidth: float = 0.10,
            max_walks: int = 100_000, min_walks: int = 256) -> float:
        """Sample until CI half-width <= rel_halfwidth * estimate (§6.1)."""
        while self.walks < max_walks:
            est, _ = self.step()
            if self.walks >= min_walks and est > 0:
                hw = self.stat.half_width(confidence)
                if hw <= rel_halfwidth * est:
                    break
        return self.stat.mean

    @property
    def estimate(self) -> float:
        return self.stat.mean
