"""Serving front-end: streaming union-sample service.

Port copy of ``repro.serve``: :class:`SampleService` wraps the torch union
engine with a prefetched sample queue and request batching; the serve CLI
(``python -m repro_torch.launch.serve --mode samples``) routes through it.
"""

from .service import SampleService

__all__ = ["SampleService"]
