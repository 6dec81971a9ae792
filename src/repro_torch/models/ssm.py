"""Mamba-2 shapes: the dims and parameter shapes of the reference's
``repro/models/ssm.py``, which ``ModelConfig.ssm_dims``, ``param_entries``
and ``cache_entries`` need for every family.

The SSD block and its decode (``mamba2_block``, ``mamba2_decode``) are not
ported yet (ROADMAP §A 6).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class SSMDims:
    d_model: int
    d_inner: int     # 2 * d_model (mamba expand=2)
    n_heads: int     # d_inner // head_dim
    head_dim: int    # P
    state: int       # N
    conv_k: int = 4

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.state  # x, B, C share the conv

    @property
    def in_proj_dim(self) -> int:
        # z, x, B, C, dt
        return 2 * self.d_inner + 2 * self.state + self.n_heads


def ssm_param_shapes(dims: SSMDims) -> Dict[str, Tuple[int, ...]]:
    return {
        "norm": (dims.d_model,),
        "in_proj": (dims.d_model, dims.in_proj_dim),
        "conv_w": (dims.conv_k, dims.conv_dim),
        "conv_b": (dims.conv_dim,),
        "A_log": (dims.n_heads,),
        "D": (dims.n_heads,),
        "dt_bias": (dims.n_heads,),
        "out_norm": (dims.d_inner,),
        "out_proj": (dims.d_inner, dims.d_model),
    }
