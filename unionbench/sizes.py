"""Request sizes of a traffic mix: a fixed grid over the mix's law, the
same for every seed (a run draws the order from its seed)."""

from __future__ import annotations

import numpy as np


def grid(traffic: dict) -> np.ndarray:
    """``grid`` quantiles of the mix's ``sizes`` law (``log_uniform``
    between ``min`` and ``max``, or ``fixed`` at ``size``); a mix without
    ``sizes`` asks for ``step`` rows each time."""
    law = traffic.get("sizes") or {"law": "fixed", "size": traffic["step"],
                                   "grid": 1}
    q = (np.arange(law["grid"]) + 0.5) / law["grid"]
    if law["law"] == "log_uniform":
        lo, hi = np.log(law["min"]), np.log(law["max"])
        return np.round(np.exp(lo + q * (hi - lo))).astype(np.int64)
    if law["law"] == "fixed":
        return np.full(law["grid"], int(law["size"]), np.int64)
    raise ValueError(f"unknown size law {law['law']!r}")
