"""int8 error-feedback gradient compression.

The port's copy of the reference's ``repro/train/grad_compress.py``:

* :func:`compress_decompress` — value level: each gradient plus the
  error-feedback residual is quantised to int8 with one per-tensor scale
  and dequantised; the quantisation residual is carried into the next step
  (Seide et al. 1-bit SGD lineage), so the compression noise is unbiased
  over time.  This is what the train step applies.
* :func:`compressed_psum` — wire level: the sum over a process group of
  int8 values with one float32 scale per rank, moved by one ``all_gather``
  of each and dequantised and summed on every rank (1 byte per element
  and peer instead of ~4 for a ring all-reduce: a win on a small, slow
  axis such as the cross-pod one).  As in the reference it stands alone;
  the train step does not call it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

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


def compressed_psum(x: torch.Tensor, group: Optional[object] = None
                    ) -> torch.Tensor:
    """Sum of ``x`` over ``group`` (a mesh axis's process group, e.g.
    :func:`repro_torch.launch.mesh.axis_group`; ``None``: a group of one)
    through int8: every rank gets the float32 sum of the ranks'
    dequantised values, in rank order."""
    q, s = _quant_int8(x.float())
    if group is None:
        return _dequant(q, s)
    import torch.distributed as dist
    world = dist.get_world_size(group)
    qg = torch.empty((world * q.numel(),), dtype=q.dtype, device=q.device)
    sg = torch.empty((world,), dtype=s.dtype, device=s.device)
    dist.all_gather_into_tensor(qg, q.reshape(-1), group=group)
    dist.all_gather_into_tensor(sg, s.reshape(1), group=group)
    deq = qg.view((world,) + tuple(x.shape)).float() * sg.reshape(
        (world,) + (1,) * x.ndim)
    return deq.sum(dim=0)
