"""Serving: KV/state caches, prefill, and single-token decode per family.

The port's copy of the reference's ``repro/models/serve.py``.  Cache
layouts (stacked on the layer axis, as the reference's):

* dense/moe/vlm : k,v (L, B, S, KV, hd); vlm's S is ``max_len +
                  n_frontend_tokens``
* gemma2        : local layers use a **window-capped ring buffer**
                  (L/2, B, W, KV, hd), W = min(window, max_len); only the
                  global half of the layers holds full-length KV
* mamba2        : h (L, B, H, N, P) + conv tail (L, B, k-1, conv_dim)
* zamba2        : per-group mamba states + one KV cache per shared-attention
                  application (G, B, S, KV, hd), and the tail's states
* encdec        : decoder self-KV + cross-attention K/V (L, B, Tf, KV, hd)

``decode_step(params, cfg, cache, tokens, lengths)`` appends one token at
position ``lengths`` (per batch row) and returns the cache and next-token
logits, for every family.  The new K/V rows and conv tails are written in
place into the stacked buffers (``index_put_``/``copy_`` on the layer's
view), so the returned cache holds the same storage as the one passed in,
with one exception that keeps the reference's dtypes: :func:`init_cache`
makes every entry in ``cfg.compute_dtype``, and the SSM state ``h``
(``h_tail``) comes back from each step in float32, as the reference's
``mamba2_decode`` returns it; a step given a state of another dtype writes
the new state into a new float32 buffer, so the state is never rounded to
bf16 between steps.  Every decode attention goes through
:func:`repro_torch.models.layers.decode_attention`, so through the B4
kernel on the card: two launches (plan + attention) per call, one call
per attention layer and step (zamba2: one per group; encdec: self and
cross per layer; mamba2: none).

As in the reference, decode never fills vlm's frontend rows nor encdec's
cross caches ``xk``/``xv``: vlm decodes from position 0, and encdec's
cross-attention attends over all ``n_frontend_tokens`` rows of whatever
the cache holds (zeros from :func:`init_cache`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..device import resolve_device
from .layers import decode_attention, rms_norm, rope, softcap, swiglu
from .moe import moe_ffn
from .ssm import mamba2_decode
from .transformer import (ModelConfig, _embed_tokens, _sub, _tail_stack,
                          forward_hidden, layer)

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


def attention_calls_per_step(cfg: ModelConfig) -> int:
    """Decode attentions (B4 calls on the card) in one :func:`decode_step`:
    one per attention layer (gemma2's local and global layers alike), one
    per zamba2 group (the shared block), two per encdec decoder layer (self
    and cross), none for mamba2."""
    return {"mamba2": 0, "zamba2": cfg.n_zamba_groups,
            "encdec": 2 * cfg.n_layers}.get(cfg.family, cfg.n_layers)


def _state_out(cache: Cache, name: str) -> torch.Tensor:
    """The buffer a step writes SSM state ``name`` into: the cache's own
    when it is float32, else a new float32 buffer of its shape."""
    h = cache[name]
    return h if h.dtype == torch.float32 else torch.empty(
        h.shape, dtype=torch.float32, device=h.device)


def _mamba_decode_into(p, x, h_in, conv, h_out, cfg: ModelConfig):
    """One SSM layer's decode: reads the state ``h_in``, writes the new
    state into ``h_out`` and the conv tail into ``conv`` in place."""
    y, st = mamba2_decode(p, x, {"h": h_in, "conv": conv}, cfg.ssm_dims)
    h_out.copy_(st["h"])
    conv.copy_(st["conv"])
    return x + y


def _moe_decode(p, x, cfg: ModelConfig):
    """The expert FFN at decode: dropless (capacity = the B tokens), plus
    arctic's dense residual on the same normed input."""
    hh = rms_norm(x, p["ln2"])
    m, _ = moe_ffn(_sub(p, "moe_"), hh, cfg.moe_dims, capacity=x.shape[0])
    if cfg.dense_residual:
        m = m + swiglu(hh, p["res_w_gate"].to(x.dtype),
                       p["res_w_up"].to(x.dtype), p["res_w_down"].to(x.dtype))
    return m


def _cross_decode(p, x, xk, xv, cfg: ModelConfig):
    """encdec's cross-attention at decode: the query of the normed token
    (no RoPE) over every one of the ``n_frontend_tokens`` rows of
    ``xk``/``xv``."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    q = (rms_norm(x, p["lnx"]) @ p["xq"].to(x.dtype)).reshape(B, H, hd)
    full = torch.full((B,), xk.shape[1], dtype=torch.int32, device=x.device)
    o = decode_attention(q, xk, xv, full)
    return (o.reshape(B, H * hd) @ p["xo"].to(x.dtype))[:, None]


def decode_step(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                cache: Cache, tokens: torch.Tensor, lengths: torch.Tensor,
                *, _blocks: Optional[int] = None
                ) -> Tuple[Cache, torch.Tensor]:
    """tokens (B,1), lengths (B,) -> (cache', logits (B,vocab) float32).
    ``_blocks``: as :func:`~repro_torch.models.transformer.forward_hidden`'s
    (the first layers, gemma2 pairs, zamba2 groups or decoder layers)."""
    x = _embed_tokens(params, cfg, tokens)
    fam = cfg.family
    new = dict(cache)

    def blocks(n: int) -> range:
        return range(n if _blocks is None else _blocks)
    if fam in ("dense", "moe", "vlm"):
        stack = _sub(params, "blocks.")
        for i in blocks(cfg.n_layers):
            p = layer(stack, i)
            a, _, _ = _attn_decode(p, x, cache["k"][i], cache["v"][i],
                                   lengths, cfg)
            x = x + a
            x = x + (_moe_decode(p, x, cfg) if fam == "moe"
                     else _mlp_decode(p, x, cfg))
    elif fam == "gemma2":                   # (local, global) pairs
        stack = _sub(params, "blocks.")
        for i in blocks(cfg.n_layers // 2):
            pe, po = layer(stack, 2 * i), layer(stack, 2 * i + 1)
            a, _, _ = _attn_decode(pe, x, cache["k_loc"][i],
                                   cache["v_loc"][i], lengths, cfg, ring=True)
            x = x + rms_norm(a, pe["ln1_post"])
            x = x + rms_norm(_mlp_decode(pe, x, cfg), pe["ln2_post"])
            a, _, _ = _attn_decode(po, x, cache["k_glob"][i],
                                   cache["v_glob"][i], lengths, cfg)
            x = x + rms_norm(a, po["ln1_post"])
            x = x + rms_norm(_mlp_decode(po, x, cfg), po["ln2_post"])
    elif fam == "mamba2":
        stack = _sub(params, "blocks.")
        new["h"] = _state_out(cache, "h")
        for i in blocks(cfg.n_layers):
            x = _mamba_decode_into(layer(stack, i), x, cache["h"][i],
                                   cache["conv"][i], new["h"][i], cfg)
    elif fam == "zamba2":
        shared = _sub(params, "shared.")
        groups = _sub(params, "blocks.")
        new["h"] = _state_out(cache, "h")
        for g in blocks(cfg.n_zamba_groups):
            gp = layer(groups, g)
            for j in range(cfg.mamba_per_attn):
                x = _mamba_decode_into(layer(gp, j), x, cache["h"][g, j],
                                       cache["conv"][g, j], new["h"][g, j],
                                       cfg)
            a, _, _ = _attn_decode(shared, x, cache["k_sh"][g],
                                   cache["v_sh"][g], lengths, cfg)
            sh = x + a
            sh = sh + _mlp_decode(shared, sh, cfg)
            mix = torch.sigmoid(params["gate"][g].float()).to(x.dtype)
            x = x + mix[None, None, :] * (sh - x)
        if cfg.n_zamba_tail > 0:
            tail = _tail_stack(params, cfg)
            new["h_tail"] = _state_out(cache, "h_tail")
            for i in range(cfg.n_zamba_tail):
                x = _mamba_decode_into(layer(tail, i), x, cache["h_tail"][i],
                                       cache["conv_tail"][i],
                                       new["h_tail"][i], cfg)
    elif fam == "encdec":
        stack = _sub(params, "dec.")
        for i in blocks(cfg.n_layers):
            p = layer(stack, i)
            a, _, _ = _attn_decode(p, x, cache["k"][i], cache["v"][i],
                                   lengths, cfg)
            x = x + a
            x = x + _cross_decode(p, x, cache["xk"][i], cache["xv"][i], cfg)
            x = x + _mlp_decode(p, x, cfg)
    else:
        raise ValueError(fam)
    x = rms_norm(x, params["final_norm"])
    return new, _logits(params, cfg, x[:, 0])


# ---------------------------------------------------------------------------
# Prefill
# ---------------------------------------------------------------------------


def prefill_step(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                 batch: Dict[str, torch.Tensor], *,
                 _blocks: Optional[int] = None) -> torch.Tensor:
    """Inference prefill: full-sequence forward -> last-token logits (B, V)
    in float32.  ``batch["tokens"]`` (B, S), and for ``encdec`` and
    ``vlm`` ``batch["frontend"]`` (B, n_frontend_tokens, d_model).
    ``_blocks``: as :func:`~repro_torch.models.transformer.forward_hidden`'s."""
    x, _ = forward_hidden(params, cfg, batch, _blocks=_blocks)
    return _logits(params, cfg, x[:, -1, :])
