"""Estimation backend for §5–§7 size/overlap estimation.

``get_estimator("torch" | <EstimatorBackend instance>, ...)`` is the single
entry point the ONLINE-UNION sampler and the random-walk warm-up use; see
:mod:`repro_torch.core.estimators.base` for the :class:`EstimatorBackend`
contract.  The port has one engine, the card's
:class:`~repro_torch.core.estimators.torch_estimator.TorchEstimator`, and no
host engine to fall back to.
"""

from __future__ import annotations

from typing import Sequence, Union

from ..index import Catalog
from ..joins import JoinSpec
from .base import (EstimatorBackend, OverlapEstimate, PoolBatch,
                   ReservoirPool, StatView)
from .torch_estimator import TorchEstimator

__all__ = [
    "EstimatorBackend", "OverlapEstimate", "PoolBatch", "ReservoirPool",
    "StatView", "TorchEstimator", "get_estimator",
]


def get_estimator(spec: Union[str, EstimatorBackend], cat: Catalog,
                  joins: Sequence[JoinSpec], seed: int = 0, batch: int = 512,
                  device=None, **kwargs) -> EstimatorBackend:
    """Resolve an estimator selector (``"torch"`` or an instance)."""
    if isinstance(spec, EstimatorBackend) and not isinstance(spec, str):
        return spec
    if spec == "torch":
        return TorchEstimator(cat, joins, seed=seed, batch=batch,
                              device=device, **kwargs)
    raise ValueError(f"unknown estimator backend {spec!r} (repro_torch has "
                     "one engine: 'torch')")

