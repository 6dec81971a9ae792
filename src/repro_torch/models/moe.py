"""Mixture-of-Experts shapes: the dims and parameter shapes of the
reference's ``repro/models/moe.py``, which ``ModelConfig.moe_dims`` and
``param_entries`` need for every family.

The expert FFN itself (``moe_ffn``) is not ported yet (ROADMAP §A 6).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class MoEDims:
    d_model: int
    n_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25


def moe_param_shapes(dims: MoEDims) -> Dict[str, Tuple[int, ...]]:
    return {
        "router": (dims.d_model, dims.n_experts),
        "w_gate": (dims.n_experts, dims.d_model, dims.d_ff),
        "w_up": (dims.n_experts, dims.d_model, dims.d_ff),
        "w_down": (dims.n_experts, dims.d_ff, dims.d_model),
    }
