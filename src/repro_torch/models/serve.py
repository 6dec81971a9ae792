"""Serving: KV caches, prefill, and single-token decode (``dense`` and
``gemma2``).

The port's copy of the reference's ``repro/models/serve.py``.  Cache
layouts (stacked on the layer axis, as the reference's):

* dense/moe/vlm : k,v (L, B, S, KV, hd)
* gemma2        : local layers use a **window-capped ring buffer**
                  (L/2, B, W, KV, hd), W = min(window, max_len); only the
                  global half of the layers holds full-length KV
* mamba2        : h (L, B, H, N, P) + conv tail (L, B, k-1, conv_dim)
* zamba2        : per-group mamba states + one KV cache per shared-attention
                  application (G, B, S, KV, hd)
* encdec        : decoder self-KV + precomputed cross-attention K/V

:func:`cache_entries` and :func:`init_cache` give every family's shapes;
:func:`decode_step` runs ``dense`` and ``gemma2`` (the other families raise
``NotImplementedError``).  ``decode_step(params, cfg, cache, tokens,
lengths)`` appends one token at position ``lengths`` (per batch row) and
returns the cache and next-token logits.  The new K/V rows are written in
place into the stacked buffers (``index_put_`` on the layer's view), so the
returned cache holds the same storage as the one passed in.  Every decode
attention goes through :func:`repro_torch.models.layers.decode_attention`,
so through the B4 kernel on the card: two launches (plan + attention) per
attention layer and step.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..device import resolve_device
from .layers import decode_attention, rms_norm, rope, softcap, swiglu
from .transformer import (ModelConfig, _embed_tokens, _sub, forward_hidden,
                          layer, require_family)

Cache = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# Cache construction
# ---------------------------------------------------------------------------


def cache_entries(cfg: ModelConfig, batch: int, max_len: int
                  ) -> Dict[str, Tuple[Tuple[int, ...], Tuple[Optional[str], ...]]]:
    """name -> (shape, logical axes)."""
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    dt = ("batch", "kvseq", None, None)
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        S = max_len + (cfg.n_frontend_tokens if fam == "vlm" else 0)
        return {"k": ((L, batch, S, KV, hd), ("layer",) + dt),
                "v": ((L, batch, S, KV, hd), ("layer",) + dt)}
    if fam == "gemma2":
        half = L // 2
        W = min(cfg.window, max_len)
        return {
            "k_loc": ((half, batch, W, KV, hd), ("layer",) + dt),
            "v_loc": ((half, batch, W, KV, hd), ("layer",) + dt),
            "k_glob": ((half, batch, max_len, KV, hd), ("layer",) + dt),
            "v_glob": ((half, batch, max_len, KV, hd), ("layer",) + dt),
        }
    if fam == "mamba2":
        d = cfg.ssm_dims
        return {
            "h": ((L, batch, d.n_heads, d.state, d.head_dim),
                  ("layer", "batch", "heads", None, None)),
            "conv": ((L, batch, d.conv_k - 1, d.conv_dim),
                     ("layer", "batch", None, "mlp")),
        }
    if fam == "zamba2":
        d = cfg.ssm_dims
        G, P = cfg.n_zamba_groups, cfg.mamba_per_attn
        ent = {
            "h": ((G, P, batch, d.n_heads, d.state, d.head_dim),
                  ("layer", None, "batch", "heads", None, None)),
            "conv": ((G, P, batch, d.conv_k - 1, d.conv_dim),
                     ("layer", None, "batch", None, "mlp")),
            "k_sh": ((G, batch, max_len, KV, hd), ("layer",) + dt),
            "v_sh": ((G, batch, max_len, KV, hd), ("layer",) + dt),
        }
        if cfg.n_zamba_tail > 0:
            ent["h_tail"] = ((cfg.n_zamba_tail, batch, d.n_heads, d.state,
                              d.head_dim), ("layer", "batch", "heads", None, None))
            ent["conv_tail"] = ((cfg.n_zamba_tail, batch, d.conv_k - 1,
                                 d.conv_dim), ("layer", "batch", None, "mlp"))
        return ent
    if fam == "encdec":
        Tf = cfg.n_frontend_tokens
        return {"k": ((L, batch, max_len, KV, hd), ("layer",) + dt),
                "v": ((L, batch, max_len, KV, hd), ("layer",) + dt),
                "xk": ((L, batch, Tf, KV, hd), ("layer",) + dt),
                "xv": ((L, batch, Tf, KV, hd), ("layer",) + dt)}
    raise ValueError(fam)


def cache_logical_axes(cfg: ModelConfig, batch: int, max_len: int):
    return {k: ax for k, (shp, ax) in cache_entries(cfg, batch, max_len).items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None
               ) -> Cache:
    """Zero caches in ``cfg.compute_dtype`` on ``device`` (``None``: the
    card)."""
    dev = resolve_device(device)
    return {k: torch.zeros(shp, dtype=cfg.compute_dtype, device=dev)
            for k, (shp, _) in cache_entries(cfg, batch, max_len).items()}


# ---------------------------------------------------------------------------
# Decode helpers
# ---------------------------------------------------------------------------


def _project_qkv(p, x, cfg: ModelConfig):
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, p["ln1"])
    q = (h @ p["wq"].to(x.dtype)).reshape(B, -1, H, hd)
    kv = (h @ p["wkv"].to(x.dtype)).reshape(B, -1, 2, KV, hd)
    return h, q, kv[:, :, 0], kv[:, :, 1]


def _attn_decode(p, x, k_cache, v_cache, lengths, cfg: ModelConfig,
                 window: int = 0, ring: bool = False):
    """One-token attention vs cache; returns (attn_out, k_cache, v_cache).
    ``k_cache``/``v_cache`` (B, W, KV, hd) are written in place: a ring
    (gemma2's local layers) at ``lengths % W``, attending with window 0 over
    ``min(lengths + 1, W)`` slots; otherwise at ``min(lengths, W - 1)``."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    _, q, k_new, v_new = _project_qkv(p, x, cfg)
    pos = lengths[:, None]                                    # (B,1)
    q = rope(q, pos, cfg.rope_theta)[:, 0]                    # (B,H,hd)
    k_new = rope(k_new, pos, cfg.rope_theta)[:, 0]            # (B,KV,hd)
    v_new = v_new[:, 0]
    W = k_cache.shape[1]
    lengths = lengths.long()
    slot = torch.remainder(lengths, W) if ring else torch.clamp(lengths,
                                                                max=W - 1)
    bidx = torch.arange(B, device=x.device)
    k_cache.index_put_((bidx, slot), k_new.to(k_cache.dtype))
    v_cache.index_put_((bidx, slot), v_new.to(v_cache.dtype))
    eff_len = torch.clamp(lengths + 1, max=W)
    o = decode_attention(q, k_cache, v_cache, eff_len,
                         window=0 if ring else window, cap=cfg.attn_softcap)
    out = o.reshape(B, H * hd) @ p["wo"].to(x.dtype)
    return out[:, None, :], k_cache, v_cache


def _mlp_decode(p, x, cfg: ModelConfig):
    return swiglu(rms_norm(x, p["ln2"]), p["w_gate"].to(x.dtype),
                  p["w_up"].to(x.dtype), p["w_down"].to(x.dtype))


def _logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, d) final hidden -> float32 logits (B, vocab): the product in the
    activations' dtype, then the float32 softcap."""
    logits = x @ params["embed"].to(x.dtype).T
    return softcap(logits.float(), cfg.final_softcap)


# ---------------------------------------------------------------------------
# decode_step
# ---------------------------------------------------------------------------


def decode_step(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                cache: Cache, tokens: torch.Tensor, lengths: torch.Tensor
                ) -> Tuple[Cache, torch.Tensor]:
    """tokens (B,1), lengths (B,) -> (cache', logits (B,vocab) float32)."""
    require_family(cfg, "decode_step")
    x = _embed_tokens(params, cfg, tokens)
    stack = _sub(params, "blocks.")
    if cfg.family == "dense":
        for i in range(cfg.n_layers):
            p = layer(stack, i)
            a, _, _ = _attn_decode(p, x, cache["k"][i], cache["v"][i],
                                   lengths, cfg)
            x = x + a
            x = x + _mlp_decode(p, x, cfg)
    else:                                   # gemma2: (local, global) pairs
        for i in range(cfg.n_layers // 2):
            pe, po = layer(stack, 2 * i), layer(stack, 2 * i + 1)
            a, _, _ = _attn_decode(pe, x, cache["k_loc"][i],
                                   cache["v_loc"][i], lengths, cfg, ring=True)
            x = x + rms_norm(a, pe["ln1_post"])
            x = x + rms_norm(_mlp_decode(pe, x, cfg), pe["ln2_post"])
            a, _, _ = _attn_decode(po, x, cache["k_glob"][i],
                                   cache["v_glob"][i], lengths, cfg)
            x = x + rms_norm(a, po["ln1_post"])
            x = x + rms_norm(_mlp_decode(po, x, cfg), po["ln2_post"])
    x = rms_norm(x, params["final_norm"])
    return dict(cache), _logits(params, cfg, x[:, 0])


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill_step(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Inference prefill: full-sequence forward -> last-token logits (B, V)
    in float32."""
    x, _ = forward_hidden(params, cfg, batch)
    return _logits(params, cfg, x[:, -1, :])
