"""Mamba-2 (SSD — state-space duality) block: the chunked scan of the
forward pass and the O(1) one-token decode.

The port's copy of the reference's ``repro/models/ssm.py``, in plain
PyTorch (the reference has no kernel here either).  The SSD form (Dao &
Gu, arXiv:2405.21060) splits the sequence into chunks of length ``Q``:
inside a chunk the recurrence is a masked decay-weighted product, and a
loop over the chunks carries the (H, N, P) state; every chunk's own terms
are computed at once, batched over the chunks, and only the state's
carry runs chunk by chunk.  Decode is the plain
recurrence ``h = a·h + B⊗(dt·x)``, ``y = C·h``: its state is O(B·H·N·P)
whatever the context length.

The carried state ``h`` is float32 in both: :func:`mamba2_decode` returns
it in float32 whatever the dtype of the state it was given (a bf16 zero
cache times float32 decays is float32, as in the reference), and the
causal conv sums its taps in float32 in the reference's order.

Training differentiates the scan with plain autograd.  The reference wraps
each chunk step in ``jax.checkpoint(nothing_saveable)``, so its backward
holds one chunk's intermediates at a time; the port recomputes at the
block level only (``forward_hidden``'s remat of each layer), so while one
block's backward runs, every chunk's intermediates of that block are alive
at once: per chunk the (B, Q, Q, H) decays, (B, Q, H, P) outputs and the
(B, H, N, P) state in float32.  At mamba2-780m's widths (H 48, N 128, P 64,
Q 128) and B 8 × S 1024 that is about 0.6 GB for the block being
recomputed, against about 80 MB for the reference's one chunk; it does not
grow with depth.  The masked exponent ``exp(where(i >= j, diff, -1e30))``
has a finite gradient: the masked entries' exponent is a constant, so they
pass no gradient to ``diff`` (the reference masks the same way).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import rms_norm


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


def _split_proj(dims: SSMDims, zxbcdt: torch.Tensor):
    di, n = dims.d_inner, dims.state
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di],
            zxbcdt[..., 2 * di:2 * di + n],
            zxbcdt[..., 2 * di + n:2 * di + 2 * n],
            zxbcdt[..., 2 * di + 2 * n:])


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d; returns (out in xbc's dtype, new_state:
    the last k-1 input rows).  xbc (B,S,C); w (k,C), b (C,) float32; the
    taps are summed in float32, i = 0..k-1."""
    k = w.shape[0]
    if state is None:
        state = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                            dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([state, xbc], dim=1)
    S = xbc.shape[1]
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(k):
        out = out + xp[:, i:i + S, :].float() * w[i][None, None, :]
    out = F.silu(out + b[None, None, :])
    return out.to(xbc.dtype), xp[:, xp.shape[1] - (k - 1):, :]


def ssd_chunked(u: torch.Tensor, log_a: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int = 128,
                h0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan. u (B,S,H,P), log_a (B,S,H), B/C (B,S,N) -> (y (B,S,H,P),
    h_final (B,H,N,P)), both float32.  ``Q = min(chunk, S)`` must divide
    S, as the reference asserts."""
    Bsz, S, H, P = u.shape
    N = B.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_chunked: chunk {Q} does not divide S = {S}")
    nc = S // Q
    u_c = u.reshape(Bsz, nc, Q, H, P).float()
    la_c = torch.cumsum(log_a.reshape(Bsz, nc, Q, H).float(), dim=2)
    B_c = B.reshape(Bsz, nc, Q, N).float()
    C_c = C.reshape(Bsz, nc, Q, N).float()
    h = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=u.device)
         if h0 is None else h0)
    idx = torch.arange(Q, device=u.device)
    tri = (idx[:, None] >= idx[None, :])[None, None, :, :, None]  # i >= j
    # every chunk's own terms at once (the reference's chunk step, batched
    # over the chunks c): intra-chunk masked decay-weighted "attention"
    g = torch.einsum("bcin,bcjn->bcij", C_c, B_c)                 # (B,nc,Q,Q)
    # mask the EXPONENT, not the result: exp of the (positive) upper
    # triangle overflows
    diff = la_c[:, :, :, None, :] - la_c[:, :, None, :, :]         # (B,nc,Qi,Qj,H)
    dec = torch.exp(torch.where(tri, diff, -1e30))
    y_in = torch.einsum("bcij,bcijh,bcjhp->bcihp", g, dec, u_c)
    # each chunk's contribution to the state it passes on
    la_end = la_c[:, :, -1, :]                                     # (B,nc,H)
    w = torch.exp(la_end[:, :, None, :] - la_c)                    # (B,nc,Q,H)
    s_new = torch.einsum("bcjn,bcjh,bcjhp->bchnp", B_c, w, u_c)
    # the carried state: the only sequential part
    a_end = torch.exp(la_end)[..., None, None]                     # (B,nc,H,1,1)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = a_end[:, c] * h + s_new[:, c]
    # inter-chunk: contribution of the state entering each chunk
    y_x = torch.einsum("bcin,bcih,bchnp->bcihp", C_c, torch.exp(la_c),
                       torch.stack(h_in, dim=1))
    return (y_in + y_x).reshape(Bsz, S, H, P), h


def _gates(params: Dict[str, torch.Tensor], dt: torch.Tensor):
    """(softplus(dt + dt_bias), A = -exp(A_log)), float32."""
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :].float())
    return dt, -torch.exp(params["A_log"].float())


def mamba2_block(params: Dict[str, torch.Tensor], x: torch.Tensor,
                 dims: SSMDims, chunk: int = 128) -> torch.Tensor:
    """Forward (training/prefill). x (B,S,d) -> (B,S,d) in x's dtype."""
    Bsz, S, _ = x.shape
    h = rms_norm(x, params["norm"])
    zxbcdt = h @ params["in_proj"].to(h.dtype)
    z, xs, Bc, Cc, dt = _split_proj(dims, zxbcdt)
    xbc, _ = _causal_conv(torch.cat([xs, Bc, Cc], dim=-1),
                          params["conv_w"].float(), params["conv_b"].float())
    xs = xbc[..., :dims.d_inner]
    Bc = xbc[..., dims.d_inner:dims.d_inner + dims.state]
    Cc = xbc[..., dims.d_inner + dims.state:]
    dt, A = _gates(params, dt)
    log_a = dt * A[None, None, :]                                 # (B,S,H)
    xh = xs.reshape(Bsz, S, dims.n_heads, dims.head_dim)
    u = xh.float() * dt[..., None]
    y, _ = ssd_chunked(u, log_a, Bc, Cc, chunk=chunk)
    y = y + params["D"].float()[None, None, :, None] * xh.float()
    y = y.reshape(Bsz, S, dims.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z), params["out_norm"])
    return y @ params["out_proj"].to(x.dtype)


def mamba2_decode(params: Dict[str, torch.Tensor], x_tok: torch.Tensor,
                  state: Dict[str, torch.Tensor], dims: SSMDims
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode. x_tok (B,1,d); state = {"h": (B,H,N,P), "conv":
    (B,k-1,conv_dim)} -> (out (B,1,d), {"h": float32, "conv": in the
    dtype of x_tok and the conv state})."""
    h_in = rms_norm(x_tok, params["norm"])
    zxbcdt = h_in @ params["in_proj"].to(x_tok.dtype)
    z, xs, Bc, Cc, dt = _split_proj(dims, zxbcdt)
    xbc, conv_state = _causal_conv(torch.cat([xs, Bc, Cc], dim=-1),
                                   params["conv_w"].float(),
                                   params["conv_b"].float(), state["conv"])
    xs = xbc[..., :dims.d_inner]
    Bc = xbc[..., dims.d_inner:dims.d_inner + dims.state]
    Cc = xbc[..., dims.d_inner + dims.state:]
    dt, A = _gates(params, dt)
    a = torch.exp(dt * A[None, None, :])[:, 0]                    # (B,H)
    xh = xs.reshape(xs.shape[0], 1, dims.n_heads, dims.head_dim)
    u = (xh.float() * dt[..., None])[:, 0]                        # (B,H,P)
    h = state["h"] * a[:, :, None, None] + torch.einsum(
        "bn,bhp->bhnp", Bc[:, 0].float(), u)
    y = torch.einsum("bn,bhnp->bhp", Cc[:, 0].float(), h)
    y = y + params["D"].float()[None, :, None] * xh[:, 0].float()
    y = y.reshape(y.shape[0], 1, dims.d_inner).to(x_tok.dtype)
    y = rms_norm(y * F.silu(z), params["out_norm"])
    out = y @ params["out_proj"].to(x_tok.dtype)
    return out, {"h": h, "conv": conv_state}
