"""Model layer library of the port: norms, RoPE, softcap, chunked attention
for the forward pass, one-token decode attention, GLU MLPs.

Plain functions on tensors, with the reference's arithmetic
(``repro/models/layers.py``) and its rounding points:

* ``rms_norm`` and ``rope`` compute in float32 and cast back to the input's
  dtype at the end (a bf16 tensor times a float32 one is float32 in torch,
  as in JAX);
* ``flash_attention`` (serving, forward only) and ``flash_attention_cv``
  (training) run a chunked online softmax over (q chunk × kv chunk) tiles
  with float32 logits and accumulators, masked as the reference's
  ``_mask_for`` masks (causal, sliding window, a bidirectional
  ``prefix_len`` prefix).  ``flash_attention_cv`` is the reference's
  custom VJP as a ``torch.autograd.Function``: the forward saves only
  ``(q, k, v, o, lse)`` and the backward recomputes each tile's logits
  (``_flash_bwd``, the reference's ``_flash_bwd_rule``).  The reference
  computes both in plain jnp outside any Pallas kernel, and so does the
  port.  Tiles whose mask is empty are skipped in both directions: their
  terms are exact zeros (``p = 0``), so the results are the same bits;
* ``decode_attention`` is the one-token GQA attention against a KV cache.
  It calls :func:`repro_torch.kernels.attention.decode_attention`, looked up
  on the module at each call: on a CUDA tensor that launches the B4 kernel
  (or raises for a shape the kernel does not take), on the CPU it runs the
  plain version.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

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


def _tile_kind(q0: int, q1: int, k0: int, k1: int, causal: bool,
               window: Optional[int], prefix_len: Optional[int]) -> str:
    """``"dead"``, ``"full"`` or ``"partial"``: whether ``_mask_for`` keeps
    none, all or some of the (q, k) pairs of the tile of query positions
    ``[q0, q1)`` and key positions ``[k0, k1)``.  A dead tile adds exact
    zeros (``p = 0``) and is skipped; a full tile needs no mask."""
    if prefix_len and k0 < prefix_len:
        # the prefix is visible to every query
        return "full" if k1 <= prefix_len else "partial"
    full = True
    if causal:
        if q1 - 1 < k0:
            return "dead"               # every key after every query
        full = q0 >= k1 - 1
    if window and window > 0:
        if k1 - 1 <= q0 - window:
            return "dead"               # every key left of every window
        full = full and k0 > q1 - 1 - window
    return "full" if full else "partial"


def _heads_major(x: torch.Tensor, KV: int) -> torch.Tensor:
    """(B,S,KV·G,D) -> float32 (B,KV,G,S,D), contiguous: each q chunk's
    tile is then a slice."""
    B, S, H, D = x.shape
    return x.reshape(B, S, KV, H // KV, D).permute(0, 2, 3, 1, 4).float(
        ).contiguous()


def _kv_major(x: torch.Tensor) -> torch.Tensor:
    """(B,T,KV,D) -> float32 (B,KV,T,D), contiguous."""
    return x.permute(0, 2, 1, 3).float().contiguous()


def _flash_fwd(q, k, v, causal: bool, window: Optional[int], cap: float,
               q_chunk: int, kv_chunk: int, prefix_len: int = 0,
               q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (B,S,H,D), k/v (B,T,KV,D) -> (o (B,S,H,D) in q's dtype, lse
    (B,S,H) float32), as the reference's ``_flash_fwd_impl``.  The logits
    and the online-softmax state are float32 (the products of bf16 inputs
    are exact in float32, as under ``preferred_element_type``).  A q
    chunk's first live tile sets the state where the reference rescales
    its empty start (``0·0 + x·1``: the same bits)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qf, kf, vf = _heads_major(q, KV), _kv_major(k), _kv_major(v)
    outs, lses = [], []
    for iq in range(S // q_chunk):
        q0 = q_offset + iq * q_chunk
        qi = qf[:, :, :, iq * q_chunk:(iq + 1) * q_chunk]
        m = l = o = None
        for ik in range(T // kv_chunk):
            k0 = ik * kv_chunk
            kind = _tile_kind(q0, q0 + q_chunk, k0, k0 + kv_chunk, causal,
                              window, prefix_len)
            if kind == "dead":
                continue
            ki, vi = kf[:, :, k0:k0 + kv_chunk], vf[:, :, k0:k0 + kv_chunk]
            logits = softcap(torch.einsum("bkgqd,bkcd->bkgqc", qi, ki)
                             * scale, cap)
            if kind == "partial":
                mask = _mask_for(q0 + torch.arange(q_chunk, device=dev),
                                 k0 + torch.arange(kv_chunk, device=dev),
                                 causal, window, prefix_len)
                logits = torch.where(mask, logits, NEG_INF)
            m1 = logits.amax(dim=-1)
            p = torch.exp(logits - m1[..., None])
            if kind == "partial":
                p = torch.where(mask, p, 0.0)
            l1 = p.sum(dim=-1)
            o1 = torch.einsum("bkgqc,bkcd->bkgqd", p, vi)
            if m is None:
                m, l, o = m1, l1, o1
                continue
            mn = torch.maximum(m, m1)
            a0, a1 = torch.exp(m - mn), torch.exp(m1 - mn)
            m, l = mn, l * a0 + l1 * a1
            o = o * a0[..., None] + o1 * a1[..., None]
        if m is None:                   # no key visible to this chunk
            m = torch.full((B, KV, G, q_chunk), NEG_INF, device=dev)
            l = torch.zeros((B, KV, G, q_chunk), device=dev)
            o = torch.zeros((B, KV, G, q_chunk, D), device=dev)
        lc = torch.clamp(l, min=1e-30)
        out = (o / lc[..., None]).to(q.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_chunk, H, D))
        lses.append((m + torch.log(lc)).permute(0, 3, 1, 2).reshape(
            B, q_chunk, H))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def _flash_bwd(q, k, v, o, lse, do, causal: bool, window: Optional[int],
               cap: float, q_chunk: int, kv_chunk: int, prefix_len: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's ``_flash_bwd_rule``: (dq, dk, dv) in the inputs'
    dtypes from the saved ``(q, k, v, o, lse)`` and ``do``, each tile's
    logits recomputed.  ``delta = rowsum(do·o)``; ``ds = p·(dp − delta)``
    times softcap's ``1 − tanh²``; per kv chunk, ``dk``/``dv`` are summed
    in float32 over the q chunks, and each tile's ``dq`` is rounded to q's
    dtype and accumulated in float32 across the kv chunks (the reference's
    order: kv chunks outside, q chunks inside)."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    qf, dof, kf, vf = (_heads_major(q, KV), _heads_major(do, KV),
                       _kv_major(k), _kv_major(v))
    lse_r = lse.reshape(B, S, KV, G).permute(0, 2, 3, 1)     # (B,KV,G,S)
    delta = torch.einsum("bkgsd,bkgsd->bkgs", dof, _heads_major(o, KV))
    dq = torch.zeros((B, KV, G, S, D), dtype=torch.float32, device=dev)
    dks, dvs = [], []
    for ik in range(T // kv_chunk):
        k0 = ik * kv_chunk
        ki, vi = kf[:, :, k0:k0 + kv_chunk], vf[:, :, k0:k0 + kv_chunk]
        dk = dv = None
        for iq in range(S // q_chunk):
            q0 = iq * q_chunk
            kind = _tile_kind(q0, q0 + q_chunk, k0, k0 + kv_chunk, causal,
                              window, prefix_len)
            if kind == "dead":
                continue
            rows = slice(q0, q0 + q_chunk)
            qi, doi = qf[:, :, :, rows], dof[:, :, :, rows]
            z = torch.einsum("bkgqd,bkcd->bkgqc", qi, ki) * scale
            if cap and cap > 0:
                t = torch.tanh(z / cap)
                logits, dz_fac = cap * t, 1.0 - t * t
            else:
                logits, dz_fac = z, None
            if kind == "partial":
                mask = _mask_for(q0 + torch.arange(q_chunk, device=dev),
                                 k0 + torch.arange(kv_chunk, device=dev),
                                 causal, window, prefix_len)
                logits = torch.where(mask, logits, NEG_INF)
            p = torch.exp(logits - lse_r[..., rows, None])
            if kind == "partial":
                p = torch.where(mask, p, 0.0)
            dv_t = torch.einsum("bkgqc,bkgqd->bkcd", p, doi)
            dp = torch.einsum("bkgqd,bkcd->bkgqc", doi, vi)
            ds = p * (dp - delta[..., rows, None])
            if dz_fac is not None:
                ds = ds * dz_fac
            dq[..., rows, :] += (torch.einsum("bkgqc,bkcd->bkgqd", ds, ki)
                                 * scale).to(q.dtype).float()
            dk_t = torch.einsum("bkgqc,bkgqd->bkcd", ds, qi) * scale
            dk, dv = ((dk_t, dv_t) if dk is None
                      else (dk + dk_t, dv + dv_t))
        if dk is None:                  # no query sees this chunk
            dk = dv = torch.zeros((B, KV, kv_chunk, D), device=dev)
        dks.append(dk.permute(0, 2, 1, 3))
        dvs.append(dv.permute(0, 2, 1, 3))
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)
    return (dq.to(q.dtype), torch.cat(dks, dim=1).to(k.dtype),
            torch.cat(dvs, dim=1).to(v.dtype))


class FlashAttentionCV(torch.autograd.Function):
    """The reference's ``jax.custom_vjp`` attention: saves only
    ``(q, k, v, o, lse)``; the backward recomputes the logits per tile, so
    no tile of the forward stays alive for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, q_chunk, kv_chunk,
                prefix_len):
        o, lse = _flash_fwd(q, k, v, causal, window, cap, q_chunk, kv_chunk,
                            prefix_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, cap, q_chunk, kv_chunk, prefix_len)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # a module global, looked up at each call (tests count the calls)
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    cap: float = 0.0, q_chunk: int = 256, kv_chunk: int = 512,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,T,KV,D) -> (B,S,H,D). Chunked online softmax,
    forward only (serving)."""
    return _flash_fwd(q, k, v, causal, window, cap,
                      fit_chunk(q.shape[1], q_chunk),
                      fit_chunk(k.shape[1], kv_chunk), q_offset=q_offset)[0]


def flash_attention_cv(q, k, v, causal: bool, window: int, cap: float,
                       q_chunk: int, kv_chunk: int, prefix_len: int
                       ) -> torch.Tensor:
    """The reference's custom-VJP attention (differentiable, recompute
    backward); the chunks must divide S and T (callers pass
    :func:`fit_chunk`)."""
    return FlashAttentionCV.apply(q, k, v, causal, window, cap, q_chunk,
                                  kv_chunk, prefix_len)


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
