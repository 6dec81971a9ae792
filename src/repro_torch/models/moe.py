"""Mixture-of-Experts FFN: top-k routing with capacity, stacked expert
GEMMs.

The port's copy of the reference's ``repro/models/moe.py::moe_ffn`` (static
shapes, no ragged tensors): per expert, the top-C tokens among those that
routed to it are gathered, pushed through the expert's stacked-weight GEMM
and scatter-added back scaled by the gate.  Tokens beyond capacity are
dropped (GShard/Switch semantics); a Switch aux load-balancing loss is
returned.

Ties are broken as ``jax.lax.top_k`` breaks them, the lower index first
(a stable descending sort): tokens with equal gate scores, such as
position 0 of sequences that share their first token, are dropped at the
capacity boundary exactly where the reference drops them.

The reference's ``moe_ffn_dist``/``moe_ffn_auto`` (expert parallelism
under ``shard_map``) belong to model sharding (ROADMAP §A 7); without a
mesh ``moe_ffn_auto`` is ``moe_ffn``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F


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


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest values and their
    indices, equal values in index order (``torch.topk`` does not promise
    an order among ties)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def moe_ffn(params: Dict[str, torch.Tensor], x: torch.Tensor, dims: MoEDims,
            capacity: Optional[int] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> (out (B,S,d) in x's dtype, float32 aux loss).

    ``capacity=T`` gives dropless routing (the decode path uses this: at
    one-token-per-sequence batches, capacity dropping would be semantic).
    """
    Bsz, S, d = x.shape
    T = Bsz * S
    xt = x.reshape(T, d)
    E, K = dims.n_experts, dims.top_k
    C = capacity if capacity is not None else max(
        int(dims.capacity_factor * K * T / E), 1)
    C = min(C, T)

    logits = xt @ params["router"].to(x.dtype)
    probs = torch.softmax(logits.float(), dim=-1)                 # (T,E)
    topv, topi = top_k_stable(probs, K)                           # (T,K)
    # normalized combine weights over the chosen experts
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    # token->expert assignment, scored by gate for capacity ranking
    assign = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    assign[torch.arange(T, device=x.device)[:, None], topi] = topv

    # per expert: top-C tokens by gate score (capacity enforcement)
    cap_score, cap_idx = top_k_stable(assign.T, C)                # (E,C)
    valid = cap_score > 0.0

    flat = cap_idx.reshape(-1)
    xg = xt[flat].reshape(E, C, d) * valid[..., None].to(x.dtype)
    g = torch.bmm(xg, params["w_gate"].to(x.dtype))
    u = torch.bmm(xg, params["w_up"].to(x.dtype))
    y = torch.bmm(F.silu(g) * u, params["w_down"].to(x.dtype))
    y = y * (cap_score[..., None] * valid[..., None]).to(y.dtype)

    out = torch.zeros((T, d), dtype=y.dtype, device=x.device).index_add_(
        0, flat, y.reshape(E * C, d))

    # Switch-style aux loss: E * sum_e (frac tokens to e) * (mean prob e)
    imp = probs.mean(dim=0)
    load = (assign > 0).float().mean(dim=0)
    aux = E * torch.sum(imp * load)
    return out.reshape(Bsz, S, d), aux
