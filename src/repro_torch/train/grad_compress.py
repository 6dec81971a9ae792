"""int8 error-feedback gradient compression, value level.

The port's copy of the reference's ``repro/train/grad_compress.py``
(:func:`compress_decompress` and its helpers): each gradient plus the
error-feedback residual is quantised to int8 with one per-tensor scale and
dequantised; the quantisation residual is carried into the next step
(Seide et al. 1-bit SGD lineage), so the compression noise is unbiased over
time.  The wire-level ``compressed_psum`` waits for model sharding
(ROADMAP §A 7).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


def _quant_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: Tensors) -> Tensors:
    return {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
            for k, v in params.items()}


def compress_decompress(grads: Tensors, state: Dict[str, Any]
                        ) -> Tuple[Tensors, Dict[str, Any]]:
    """(dequantised gradients in their own dtypes, state with the new
    ``ef`` residuals)."""
    ef = state.get("ef")
    if ef is None:
        ef = init_error_feedback(grads)
    out, new_ef = {}, {}
    for k, g in grads.items():
        g32 = g.float() + ef[k]
        deq = _dequant(*_quant_int8(g32))
        out[k] = deq.to(g.dtype)
        new_ef[k] = g32 - deq
    new_state = dict(state)
    new_state["ef"] = new_ef
    return out, new_state
