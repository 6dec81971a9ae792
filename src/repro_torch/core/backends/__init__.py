"""Execution backends of the port's union sampling engine.

``get_backend("torch" | "numpy" | <Backend instance>, ...)`` is the single
entry point the samplers use; see :mod:`repro_torch.core.backends.base` for
the :class:`CandidateSource` / :class:`MembershipOracle` contracts.
``"torch"`` is the card's engine
(:class:`~repro_torch.core.backends.torch_backend.TorchBackend`),
``"numpy"`` the reference's host engine
(:class:`~repro_torch.core.backends.numpy_backend.NumpyBackend`).
"""

from __future__ import annotations

from typing import Sequence, Union

from ..index import Catalog
from ..joins import JoinSpec
from .base import Backend, CandidateSource, MembershipOracle, Rows
from .numpy_backend import NumpyBackend, NumpyCandidateSource

__all__ = [
    "Backend", "CandidateSource", "MembershipOracle", "Rows",
    "NumpyBackend", "NumpyCandidateSource", "get_backend",
]


def get_backend(spec: Union[str, Backend], cat: Catalog,
                joins: Sequence[JoinSpec], join_method: str = "ew",
                seed: int = 0, device=None) -> Backend:
    """Resolve a backend selector.  A :class:`Backend` instance is used as
    it is (its device and seeds hold); ``"torch"`` builds a ``TorchBackend``
    on ``device`` (``None`` means the card and raises without one);
    ``"numpy"`` builds the host engine, which takes no device."""
    if isinstance(spec, Backend):
        return spec
    if spec == "numpy":
        return NumpyBackend(cat, joins, join_method=join_method, seed=seed)
    if spec == "torch":
        from .torch_backend import TorchBackend
        return TorchBackend(cat, joins, device=device, seed=seed,
                            join_method=join_method)
    raise ValueError(f"unknown backend {spec!r} (expected 'torch' or "
                     "'numpy')")
