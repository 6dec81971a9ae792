"""Mamba-2 (SSD — state-space duality) block: the chunked scan of the
forward pass and the O(1) one-token decode.

The port's copy of the reference's ``repro/models/ssm.py``, in plain
PyTorch (the reference has no kernel here either).  The SSD form (Dao &
Gu, arXiv:2405.21060) splits the sequence into chunks of length ``Q``:
inside a chunk the recurrence is a masked decay-weighted product, and a
loop over the chunks carries the (H, N, P) state.  Decode is the plain
recurrence ``h = a·h + B⊗(dt·x)``, ``y = C·h``: its state is O(B·H·N·P)
whatever the context length.

The carried state ``h`` is float32 in both: :func:`mamba2_decode` returns
it in float32 whatever the dtype of the state it was given (a bf16 zero
cache times float32 decays is float32, as in the reference), and the
causal conv sums its taps in float32 in the reference's order.
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
    tri = (idx[:, None] >= idx[None, :])[None, :, :, None]    # i >= j
    ys = []
    for c in range(nc):
        uc, lac, bc, cc = u_c[:, c], la_c[:, c], B_c[:, c], C_c[:, c]
        # intra-chunk: masked decay-weighted "attention"
        g = torch.einsum("bin,bjn->bij", cc, bc)                  # (B,Q,Q)
        # mask the EXPONENT, not the result: exp of the (positive) upper
        # triangle overflows
        diff = lac[:, :, None, :] - lac[:, None, :, :]            # (B,Qi,Qj,H)
        dec = torch.exp(torch.where(tri, diff, -1e30))
        y_in = torch.einsum("bij,bijh,bjhp->bihp", g, dec, uc)
        # inter-chunk: contribution of the carried state
        y_x = torch.einsum("bin,bih,bhnp->bihp", cc, torch.exp(lac), h)
        # state update
        la_end = lac[:, -1:, :]                                   # (B,1,H)
        w = torch.exp(la_end - lac)                               # (B,Q,H)
        s_new = torch.einsum("bjn,bjh,bjhp->bhnp", bc, w, uc)
        h = torch.exp(la_end[:, 0, :])[:, :, None, None] * h + s_new
        ys.append(y_in + y_x)
    return torch.stack(ys, dim=1).reshape(Bsz, S, H, P), h


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
