"""Estimation backend for §5–§7 size/overlap estimation.

``get_estimator("torch" | <EstimatorBackend instance>, ...)`` is the single
entry point the ONLINE-UNION sampler and the random-walk warm-up use; see
:mod:`repro_torch.core.estimators.base` for the :class:`EstimatorBackend`
contract.  ``"torch"`` is the card's
:class:`~repro_torch.core.estimators.torch_estimator.TorchEstimator`,
``"numpy"`` the reference's host
:class:`~repro_torch.core.estimators.numpy_estimator.NumpyEstimator`.
"""

from __future__ import annotations

from typing import Sequence, Union

from ..index import Catalog
from ..joins import JoinSpec
from .base import (EstimatorBackend, OverlapEstimate, PoolBatch,
                   ReservoirPool, StatView)
from .numpy_estimator import NumpyEstimator
from .torch_estimator import TorchEstimator

__all__ = [
    "EstimatorBackend", "NumpyEstimator", "OverlapEstimate", "PoolBatch",
    "ReservoirPool", "StatView", "TorchEstimator", "get_estimator",
]


def get_estimator(spec: Union[str, EstimatorBackend], cat: Catalog,
                  joins: Sequence[JoinSpec], seed: int = 0, batch: int = 512,
                  device=None, **kwargs) -> EstimatorBackend:
    """Resolve an estimator selector (``"torch"``, ``"numpy"`` or an
    instance).  ``device`` and the other keywords are the device
    estimator's; the host estimator takes ``pool_cap`` only."""
    if isinstance(spec, EstimatorBackend) and not isinstance(spec, str):
        return spec
    if spec == "torch":
        return TorchEstimator(cat, joins, seed=seed, batch=batch,
                              device=device, **kwargs)
    if spec == "numpy":
        return NumpyEstimator(cat, joins, seed=seed, batch=batch,
                              pool_cap=kwargs.get("pool_cap", 512))
    raise ValueError(f"unknown estimator backend {spec!r} (expected 'torch' "
                     "or 'numpy')")

