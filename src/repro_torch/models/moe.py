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

Training differentiates it as the reference does: through the stable
sort's gather of ``assign.T`` (the top-C gate scores), the in-place
``assign[...] = topv`` and ``index_add_``; the backward scatters to the
indices the forward picked, so ties keep the reference's order there too.

:func:`moe_ffn_dist` is the reference's expert-parallel path (``shard_map``
there), per rank here, with the reference's gradients on every rank (see
its docstring).
:func:`moe_ffn_auto` takes it under an ambient mesh
(:func:`repro_torch.launch.mesh.set_mesh`) where the reference does, and
``moe_ffn`` otherwise.
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


def _route(xt: torch.Tensor, router: torch.Tensor, K: int, C: int):
    """Router softmax, top-K gates normalised over the chosen experts, the
    (T, E) assignment scored by gate, and each expert's top-C tokens by
    score: (probs, assign, cap_score (E, C), cap_idx (E, C))."""
    T, E = xt.shape[0], router.shape[1]
    probs = torch.softmax((xt @ router.to(xt.dtype)).float(), dim=-1)
    topv, topi = top_k_stable(probs, K)                           # (T,K)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    assign = torch.zeros((T, E), dtype=torch.float32, device=xt.device)
    assign[torch.arange(T, device=xt.device)[:, None], topi] = topv
    cap_score, cap_idx = top_k_stable(assign.T, C)                # (E,C)
    return probs, assign, cap_score, cap_idx


def _experts(xt: torch.Tensor, cap_score: torch.Tensor, cap_idx: torch.Tensor,
             w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor
             ) -> torch.Tensor:
    """Gather each expert's C tokens, run the stacked SwiGLU GEMMs, scale
    by the gate and scatter-add back: (T, d) in xt's dtype."""
    n_e, C = cap_idx.shape
    d = xt.shape[1]
    valid = cap_score > 0.0
    flat = cap_idx.reshape(-1)
    xg = xt[flat].reshape(n_e, C, d) * valid[..., None].to(xt.dtype)
    g = torch.bmm(xg, w_gate.to(xt.dtype))
    u = torch.bmm(xg, w_up.to(xt.dtype))
    y = torch.bmm(F.silu(g) * u, w_down.to(xt.dtype))
    y = y * (cap_score[..., None] * valid[..., None]).to(y.dtype)
    return torch.zeros(xt.shape, dtype=y.dtype, device=xt.device).index_add_(
        0, flat, y.reshape(n_e * C, d))


def _switch_aux(probs: torch.Tensor, assign: torch.Tensor) -> torch.Tensor:
    """Switch-style aux loss: E · Σ_e (share of tokens routed to e) · (mean
    router prob of e)."""
    load = (assign > 0).float().mean(dim=0)
    return probs.shape[1] * torch.sum(probs.mean(dim=0) * load)


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
    probs, assign, cap_score, cap_idx = _route(xt, params["router"], K, C)
    out = _experts(xt, cap_score, cap_idx, params["w_gate"], params["w_up"],
                   params["w_down"])
    return out.reshape(Bsz, S, d), _switch_aux(probs, assign)


# ---------------------------------------------------------------------------
# expert parallelism over a mesh's process groups (the reference's shard_map
# path: local dispatch + one psum over "model")
# ---------------------------------------------------------------------------


class _ReplicatedGrad(torch.autograd.Function):
    """Identity forward; the backward sums the incoming gradient over
    ``groups`` (Megatron's *f* operator).  At the entry of the per-rank
    block it turns each rank's share of a replicated input's gradient into
    the whole gradient, on every rank."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g, None


class _LocalExperts(torch.autograd.Function):
    """This rank's ``n`` experts, rows ``[j·n, (j+1)·n)`` of a replicated
    stack of expert weights.  The backward sums their gradient's shares
    over ``data_groups`` and gathers the slices of the ``model`` group in
    group-rank order, so every rank holds the whole stack's gradient."""

    @staticmethod
    def forward(ctx, w, j, n, data_groups, model):
        ctx.data_groups, ctx.model = data_groups, model
        return w.narrow(0, j * n, n)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.contiguous().clone()
        for grp in ctx.data_groups:
            dist.all_reduce(g, group=grp)
        if ctx.model is not None:
            full = torch.empty((dist.get_world_size(ctx.model) * g.shape[0],)
                               + tuple(g.shape[1:]), dtype=g.dtype,
                               device=g.device)
            dist.all_gather_into_tensor(full, g, group=ctx.model)
            g = full
        return g, None, None, None, None


class _SumPartials(torch.autograd.Function):
    """``all_reduce(SUM)`` of distinct partial results over ``group``; the
    sum is one value that every rank of the group holds, so each partial's
    cotangent is that value's cotangent, unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    """``all_gather`` along dim 0 over ``group`` (rows in group-rank
    order); the result is one value that every rank of the group holds, so
    each rank's rows take their own slice of its cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.rank, ctx.n = dist.get_rank(group), dist.get_world_size(group)
        y = torch.empty((ctx.n * x.shape[0],) + tuple(x.shape[1:]),
                        dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(y, x.contiguous(), group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=0)[ctx.rank], None


class _SharedMean(torch.autograd.Function):
    """Mean over ``groups`` of a value of which each rank holds one of
    ``copies`` equal copies; the mean is one value that every rank holds,
    so each copy takes ``1 / (n · copies)`` of its cotangent."""

    @staticmethod
    def forward(ctx, x, groups, copies):
        import torch.distributed as dist
        y, n = x.clone(), 1
        for g in groups:
            dist.all_reduce(y, group=g)
            n *= dist.get_world_size(g)
        ctx.share = 1.0 / (n * copies)
        return y / n

    @staticmethod
    def backward(ctx, g):
        return g * ctx.share, None, None


def moe_ffn_dist(params: Dict[str, torch.Tensor], x: torch.Tensor,
                 dims: MoEDims) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE on the ambient ``DeviceMesh``, per rank (the
    reference's ``shard_map`` block): x (B,S,d) and ``params`` as the
    reference takes them, whole on every rank; returns (out (B,S,d) in x's
    dtype, float32 aux), both whole on every rank.

    Rank (i, j) of the data axes × "model": routes its data shard
    ``x[i·B/dd : (i+1)·B/dd]`` with the full router, takes every expert's
    top-C over those tokens (``C`` from the shard's token count), keeps its
    ``E/mo`` local experts ``j·E_loc …``, runs their GEMMs, scatters back
    and sums the partial outputs over the "model" group in x's dtype (the
    reference's ``psum``); the data shards' outputs are then gathered over
    the data axes (pod-major, as the reference's ``P(("pod", "data"))``).
    The aux loss is the per-shard Switch aux averaged over the data axes
    (the reference's ``pmean``), not the dense aux.

    Gradient convention: the reference's.  The code around the block is
    replicated (every rank computes the same residual, norms and loss of
    the whole outputs), so every rank gets the whole gradient of ``x`` and
    of the four weights, as under ``shard_map``.  Inside the block each
    rank's gradients are its share: the sum over "model" hands each
    partial the output's cotangent unchanged, the gather over the data
    axes hands each shard its own rows, and the aux, computed alike by the
    ``mo`` model ranks of a shard, hands each ``1 / (dd · mo)`` of its
    cotangent.  At the block's entry x and the router pass an operator
    whose backward sums those shares over every rank of the mesh, and each
    rank's slice of the expert weights one that sums its shares over the
    data axes and gathers the slices over "model" (Megatron's *f*
    operators).  At one rank it is ``moe_ffn`` with the same ``C``."""
    from ..launch.mesh import (ambient_mesh, axes_size, axis_group,
                               axis_index, axis_sizes, data_axes)
    am = ambient_mesh()
    da = data_axes(am)
    dd = axes_size(am, da)
    mo = axis_sizes(am)["model"]
    E, K = dims.n_experts, dims.top_k
    E_loc = E // mo
    Bsz, S, d = x.shape
    B_loc = Bsz // dd
    T_loc = B_loc * S
    C = min(max(int(dims.capacity_factor * K * T_loc / E), 1), T_loc)
    i, j = axis_index(am, da), axis_index(am, ("model",))
    groups = [g for g in (axis_group(am, a) for a in da) if g is not None]
    model = axis_group(am, "model")
    router = params["router"]
    everyone = groups + ([model] if model is not None else [])
    if everyone:
        x = _ReplicatedGrad.apply(x, everyone)
        router = _ReplicatedGrad.apply(router, everyone)
    w = {k: _LocalExperts.apply(params[k], j, E_loc, groups, model)
         for k in ("w_gate", "w_up", "w_down")}

    xt = x[i * B_loc:(i + 1) * B_loc].reshape(T_loc, d)
    probs, assign, cap_score, cap_idx = _route(xt, router, K, C)
    mine = slice(j * E_loc, (j + 1) * E_loc)
    out = _experts(xt, cap_score[mine], cap_idx[mine], w["w_gate"],
                   w["w_up"], w["w_down"])
    if model is not None:
        out = _SumPartials.apply(out, model)
    aux = _switch_aux(probs, assign)
    if groups or mo > 1:
        aux = _SharedMean.apply(aux, groups, mo)
    for g in reversed(groups):                  # minor axis first
        out = _GatherRows.apply(out, g)
    return out.reshape(Bsz, S, d), aux


def moe_ffn_auto(params: Dict[str, torch.Tensor], x: torch.Tensor,
                 dims: MoEDims) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`moe_ffn_dist` when the ambient mesh allows it (a "model" axis
    of size > 1 that divides the experts, and a batch the data axes
    divide); :func:`moe_ffn` otherwise."""
    from ..launch.mesh import ambient_mesh, axes_size, axis_names, \
        axis_sizes, data_axes
    am = ambient_mesh()
    if am is not None and "model" in axis_names(am):
        mo = axis_sizes(am)["model"]
        dd = axes_size(am, data_axes(am))
        if mo > 1 and dims.n_experts % mo == 0 and x.shape[0] % max(dd, 1) == 0:
            return moe_ffn_dist(params, x, dims)
    return moe_ffn(params, x, dims)
