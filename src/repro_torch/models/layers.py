"""Model layer library of the port: norms, RoPE, softcap, chunked attention
for the forward pass, one-token decode attention, GLU MLPs.

Plain functions on tensors, with the reference's arithmetic
(``repro/models/layers.py``) and its rounding points:

* ``rms_norm`` and ``rope`` compute in float32 and cast back to the input's
  dtype at the end (a bf16 tensor times a float32 one is float32 in torch,
  as in JAX);
* ``flash_attention`` / ``flash_attention_cv`` are the forward pass only:
  a chunked online softmax over (q chunk × kv chunk) tiles with float32
  logits and accumulators, masked as the reference's ``_mask_for`` masks
  (causal, sliding window, a bidirectional ``prefix_len`` prefix).  The
  reference computes this in plain jnp outside any Pallas kernel; the
  custom-VJP backward waits for the training slice;
* ``decode_attention`` is the one-token GQA attention against a KV cache.
  It calls :func:`repro_torch.kernels.attention.decode_attention`, looked up
  on the module at each call: on a CUDA tensor that launches the B4 kernel
  (or raises for a shape the kernel does not take), on the CPU it runs the
  plain version.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from ..kernels import attention as _attention

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms / rotary / softcap
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """x (..., S, H, D), positions (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq[None, :]   # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


# ---------------------------------------------------------------------------
# Chunked attention (prefill / forward)
# ---------------------------------------------------------------------------


def fit_chunk(total: int, want: int) -> int:
    """Largest chunk <= want that divides total (whisper's 1500 -> 250)."""
    c = max(min(want, total), 1)
    while total % c:
        c -= 1
    return c


def _mask_for(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
              window: Optional[int], prefix_len: Optional[int]
              ) -> torch.Tensor:
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        c = qpos[:, None] >= kpos[None, :]
        if prefix_len:
            c |= kpos[None, :] < prefix_len
        mask &= c
    if window and window > 0:
        w = kpos[None, :] > (qpos[:, None] - window)
        if prefix_len:
            w |= kpos[None, :] < prefix_len
        mask &= w
    return mask


def _flash_fwd(q, k, v, causal: bool, window: Optional[int], cap: float,
               q_chunk: int, kv_chunk: int, prefix_len: int = 0,
               q_offset: int = 0) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,T,KV,D) -> (B,S,H,D) in q's dtype.  The logits
    and the online-softmax state are float32 (the products of bf16 inputs
    are exact in float32, as under ``preferred_element_type``)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    outs = []
    for iq in range(S // q_chunk):
        qi = q[:, iq * q_chunk:(iq + 1) * q_chunk].reshape(
            B, q_chunk, KV, G, D).permute(0, 2, 3, 1, 4).float()
        qpos = q_offset + iq * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, KV, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, q_chunk), dtype=torch.float32, device=dev)
        o = torch.zeros((B, KV, G, q_chunk, D), dtype=torch.float32,
                        device=dev)
        for ik in range(T // kv_chunk):
            sl = slice(ik * kv_chunk, (ik + 1) * kv_chunk)
            ki = k[:, sl].permute(0, 2, 1, 3).float()     # (B,KV,Ck,D)
            vi = v[:, sl].permute(0, 2, 1, 3).float()
            kpos = ik * kv_chunk + torch.arange(kv_chunk, device=dev)
            logits = torch.einsum("bkgqd,bkcd->bkgqc", qi, ki) * scale
            logits = softcap(logits, cap)
            mask = _mask_for(qpos, kpos, causal, window, prefix_len)
            logits = torch.where(mask, logits, NEG_INF)
            m1 = logits.amax(dim=-1)
            p = torch.exp(logits - m1[..., None])
            p = torch.where(mask, p, 0.0)
            l1 = p.sum(dim=-1)
            o1 = torch.einsum("bkgqc,bkcd->bkgqd", p, vi)
            mn = torch.maximum(m, m1)
            a0, a1 = torch.exp(m - mn), torch.exp(m1 - mn)
            m, l = mn, l * a0 + l1 * a1
            o = o * a0[..., None] + o1 * a1[..., None]
        out = (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, D))
    return torch.cat(outs, dim=1)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    cap: float = 0.0, q_chunk: int = 256, kv_chunk: int = 512,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,T,KV,D) -> (B,S,H,D). Chunked online softmax."""
    return _flash_fwd(q, k, v, causal, window, cap,
                      fit_chunk(q.shape[1], q_chunk),
                      fit_chunk(k.shape[1], kv_chunk), q_offset=q_offset)


def flash_attention_cv(q, k, v, causal: bool, window: int, cap: float,
                       q_chunk: int, kv_chunk: int, prefix_len: int
                       ) -> torch.Tensor:
    """The reference's custom-VJP attention, forward only; the chunks must
    divide S and T (callers pass :func:`fit_chunk`)."""
    return _flash_fwd(q, k, v, causal, window, cap, q_chunk, kv_chunk,
                      prefix_len)


# ---------------------------------------------------------------------------
# Decode attention (single new token vs cache)
# ---------------------------------------------------------------------------


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: torch.Tensor, *,
                     window: Optional[int] = None, cap: float = 0.0
                     ) -> torch.Tensor:
    """q (B,H,D), cache (B,T,KV,D), length (B,) -> (B,H,D) in q's dtype:
    B4 on the card, its plain version on the CPU."""
    return _attention.decode_attention(q, k_cache, v_cache, length,
                                       softcap=float(cap or 0.0),
                                       window=int(window or 0))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def gelu_mlp(x: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor
             ) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x @ w_up, approximate="tanh") @ w_down
