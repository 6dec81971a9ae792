"""Model assembly of the port: ``ModelConfig``, parameter shapes, the
forward pass and the training loss.

The port's copy of the reference's ``repro/models/transformer.py``.  The
forward pass (:func:`forward_hidden`) runs every family:

* ``dense``   — pre-norm GQA transformer (minitron / granite / mistral-large
                / unionlm)
* ``gemma2``  — alternating local (sliding-window, even layers) and global
                (odd layers) attention, logit softcaps, pre+post sublayer
                norms, embedding scaling
* ``moe``     — dense attention + top-k expert FFN (phi3.5-moe / arctic;
                arctic adds a parallel dense-residual FFN); the aux loss is
                summed over the layers
* ``mamba2``  — attention-free SSD stack
* ``zamba2``  — mamba2 backbone with a single *shared* attention+MLP block
                applied after every ``mamba_per_attn`` SSM layers, mixed
                back in through a per-group ``sigmoid(gate)``
* ``encdec``  — whisper-style encoder-decoder (the encoder consumes
                precomputed frame embeddings, ``batch["frontend"]``; the
                decoder cross-attends to its output)
* ``vlm``     — paligemma: precomputed patch embeddings prepended to the
                text (bidirectional over the ``prefix_len`` prefix)

The training loss (:func:`forward_train`) runs every family, with the
reference's two family rules: ``vlm``'s patch prefix carries no target,
and ``moe``'s loss adds ``0.01 ·`` the layers' summed aux loss (its
``metrics["loss"]`` stays the NLL).  ``encdec`` and ``vlm`` need
``batch["frontend"]`` (the reference's train CLI feeds tokens/targets
only, so those two fail there, here as in the reference, with a
``KeyError`` naming it).  Parameters are a plain dict under the
reference's names (``blocks.wq`` …) with the stacked ``(L, …)`` layout;
where the reference scans over layers the port loops over the layers of
the stacked tensors (``unbind``, whose backward stacks the per-layer
gradients into one ``(L, …)`` gradient).  With ``cfg.remat`` and gradients
on, each block (a zamba2 group, as the reference's scan body) runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``; it changes
memory, never values), and :func:`_chunked_xent` recomputes each loss
chunk's logits in the backward, so the full ``(B, S, V)`` logits never
exist.  The reference's sharding constraints are no-ops without a mesh and
are GSPMD constraints with no eager counterpart and stay out (see
:mod:`repro_torch.launch.sharding`); the moe block calls
:func:`~repro_torch.models.moe.moe_ffn_auto`, which runs the reference's
expert-parallel ``moe_ffn_dist`` under an ambient mesh
(:func:`repro_torch.launch.mesh.set_mesh`) and ``moe_ffn`` otherwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .layers import (fit_chunk, flash_attention_cv, rms_norm, rope, softcap,
                     swiglu)
from .moe import MoEDims, moe_ffn_auto, moe_param_shapes
from .ssm import SSMDims, mamba2_block, ssm_param_shapes

PAD_ID = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    rope_theta: float = 10000.0
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    window: int = 0
    n_experts: int = 0
    top_k: int = 0
    moe_dff: int = 0
    moe_capacity_factor: float = 1.25
    dense_residual: bool = False
    ssm_state: int = 0
    ssm_headdim: int = 64
    mamba_per_attn: int = 0
    frontend: str = "none"            # "none" | "audio" | "patch"
    n_frontend_tokens: int = 0
    encdec: bool = False
    n_enc_layers: int = 0
    prefix_len: int = 0
    embed_scale: bool = False
    remat: bool = True
    q_chunk: int = 256
    kv_chunk: int = 512
    ssd_chunk: int = 128
    loss_chunk: int = 512
    dtype: str = "bfloat16"

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    @property
    def sub_quadratic(self) -> bool:
        return self.family in ("mamba2", "zamba2", "gemma2")

    @property
    def ssm_dims(self) -> SSMDims:
        d_inner = 2 * self.d_model
        return SSMDims(self.d_model, d_inner, d_inner // self.ssm_headdim,
                       self.ssm_headdim, self.ssm_state)

    @property
    def moe_dims(self) -> MoEDims:
        return MoEDims(self.d_model, self.n_experts, self.top_k, self.moe_dff,
                       self.moe_capacity_factor)

    @property
    def n_zamba_groups(self) -> int:
        return self.n_layers // (self.mamba_per_attn + 1)

    @property
    def n_zamba_tail(self) -> int:
        return self.n_layers - self.n_zamba_groups * (self.mamba_per_attn + 1)


# ---------------------------------------------------------------------------
# Parameter shapes / logical sharding axes
# ---------------------------------------------------------------------------

Entries = Dict[str, Tuple[Tuple[int, ...], Tuple[Optional[str], ...]]]

_SSM_AXES = {"norm": ("embed",), "in_proj": ("embed", "mlp"),
             "conv_w": (None, "mlp"), "conv_b": ("mlp",),
             "A_log": ("heads",), "D": ("heads",), "dt_bias": ("heads",),
             "out_norm": ("mlp",), "out_proj": ("mlp", "embed")}


def _attn_shapes(cfg: ModelConfig) -> Entries:
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "ln1": ((d,), ("embed",)),
        "wq": ((d, H * hd), ("embed", "heads")),
        "wkv": ((d, 2 * KV * hd), ("embed", "heads")),
        "wo": ((H * hd, d), ("heads", "embed")),
    }


def _mlp_shapes(cfg: ModelConfig, ff: Optional[int] = None) -> Entries:
    d = cfg.d_model
    f = ff if ff is not None else cfg.d_ff
    return {
        "ln2": ((d,), ("embed",)),
        "w_gate": ((d, f), ("embed", "mlp")),
        "w_up": ((d, f), ("embed", "mlp")),
        "w_down": ((f, d), ("mlp", "embed")),
    }


def _block_shapes(cfg: ModelConfig) -> Entries:
    fam = cfg.family
    if fam in ("dense", "vlm"):
        return {**_attn_shapes(cfg), **_mlp_shapes(cfg)}
    if fam == "gemma2":
        out = {**_attn_shapes(cfg), **_mlp_shapes(cfg)}
        out["ln1_post"] = ((cfg.d_model,), ("embed",))
        out["ln2_post"] = ((cfg.d_model,), ("embed",))
        return out
    if fam == "moe":
        out = {**_attn_shapes(cfg)}
        out["ln2"] = ((cfg.d_model,), ("embed",))
        for k, shp in moe_param_shapes(cfg.moe_dims).items():
            ax = {"router": ("embed", "experts"),
                  "w_gate": ("experts", "embed", "mlp"),
                  "w_up": ("experts", "embed", "mlp"),
                  "w_down": ("experts", "mlp", "embed")}[k]
            out[f"moe_{k}"] = (shp, ax)
        if cfg.dense_residual:
            for k, (shp, ax) in _mlp_shapes(cfg, cfg.d_ff).items():
                out[f"res_{k}"] = (shp, ax)
        return out
    if fam == "mamba2":
        return {k: (shp, _SSM_AXES[k])
                for k, shp in ssm_param_shapes(cfg.ssm_dims).items()}
    if fam == "encdec":
        out = {**_attn_shapes(cfg), **_mlp_shapes(cfg)}
        # cross attention (decoder only; encoder stack ignores these)
        out["lnx"] = ((cfg.d_model,), ("embed",))
        out["xq"] = ((cfg.d_model, cfg.n_heads * cfg.head_dim), ("embed", "heads"))
        out["xkv"] = ((cfg.d_model, 2 * cfg.n_kv_heads * cfg.head_dim), ("embed", "heads"))
        out["xo"] = ((cfg.n_heads * cfg.head_dim, cfg.d_model), ("heads", "embed"))
        return out
    raise ValueError(fam)


def _stack(shapes: Entries, n: int) -> Entries:
    return {k: ((n,) + shp, ("layer",) + tuple(ax))
            for k, (shp, ax) in shapes.items()}


def param_entries(cfg: ModelConfig) -> Entries:
    """name -> (shape, logical axes) for every parameter."""
    d = cfg.d_model
    out: Entries = {
        "embed": ((cfg.vocab, d), ("vocab", "embed")),
        "final_norm": ((d,), ("embed",)),
    }
    fam = cfg.family
    if fam == "zamba2":
        ssm = {k: (shp, _SSM_AXES[k])
               for k, shp in ssm_param_shapes(cfg.ssm_dims).items()}
        G, P = cfg.n_zamba_groups, cfg.mamba_per_attn
        for k, (shp, ax) in ssm.items():
            out[f"blocks.{k}"] = ((G, P) + shp, ("layer", None) + ax)
        for k, (shp, ax) in ssm.items():
            out[f"tail.{k}"] = ((max(cfg.n_zamba_tail, 1),) + shp, ("layer",) + ax)
        shared = {**_attn_shapes(cfg), **_mlp_shapes(cfg)}
        for k, (shp, ax) in shared.items():
            out[f"shared.{k}"] = (shp, ax)
        out["gate"] = ((G, d), ("layer", "embed"))
        return out
    if fam == "encdec":
        for k, (shp, ax) in _stack(_block_shapes(cfg), cfg.n_layers).items():
            out[f"dec.{k}"] = (shp, ax)
        enc_blk = {**_attn_shapes(cfg), **_mlp_shapes(cfg)}
        for k, (shp, ax) in _stack(enc_blk, cfg.n_enc_layers).items():
            out[f"enc.{k}"] = (shp, ax)
        out["enc_final_norm"] = ((d,), ("embed",))
        return out
    for k, (shp, ax) in _stack(_block_shapes(cfg), cfg.n_layers).items():
        out[f"blocks.{k}"] = (shp, ax)
    return out


def logical_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    return {k: ax for k, (shp, ax) in param_entries(cfg).items()}


def init_law(name: str, shape: Tuple[int, ...]) -> str:
    """The reference's initial law of a parameter (``init_params``):
    ``"zeros"`` (norms, gates, D, dt_bias, conv_b), ``"log_uniform"``
    (A_log: log U(1, 16)) or ``"normal"`` (N(0, 1) / sqrt(fan_in))."""
    if (any(t in name for t in ("ln", "norm", "gate")) and len(shape) <= 2
            and "w_" not in name):
        return "zeros"
    if name.endswith("A_log"):
        return "log_uniform"
    if name.endswith(("D", "dt_bias", "conv_b")):
        return "zeros"
    return "normal"


def param_dtype(cfg: ModelConfig, name: str, shape: Tuple[int, ...]
                ) -> torch.dtype:
    """The dtype the port stores a parameter in: the weights (the normal
    law) in ``cfg.compute_dtype``, every other parameter in float32.  The
    reference keeps float32 masters and casts each weight to the
    activations' dtype at every use (``.astype(x.dtype)``) and each norm
    scale to float32, so storing the cast gives exactly its values.

    The one weight kept in float32 is the SSM's causal-conv kernel
    ``conv_w``: the reference casts it to float32 at each use
    (``repro/models/ssm.py:148`` and ``:174``,
    ``params["conv_w"].astype(jnp.float32)``), so rounding it to bf16
    would change the conv's values."""
    if name.endswith("conv_w"):
        return torch.float32
    return cfg.compute_dtype if init_law(name, shape) == "normal" \
        else torch.float32


def init_params(cfg: ModelConfig, seed: int = 0, device=None, dtype=None
                ) -> Dict[str, torch.Tensor]:
    """Random parameters on ``device`` (``None``: the card) from a
    ``torch.Generator`` seeded with ``seed``, under the reference's law:
    N(0, 1)/sqrt(fan_in) for the weights (``fan_in`` the second-to-last
    dimension), zeros for norms and gates, log U(1, 16) for ``A_log``.

    The values are not the reference's: its numpy stream would take about
    9·10⁹ float64 draws on the host at full width, too slow for a smoke run
    (tests feed both packages the same numpy parameters through
    :func:`repro_torch.interop.params_from_numpy` instead).  Weights are
    drawn per layer in float32 and stored in :func:`param_dtype`, so no
    float32 copy of a model stays beside its bf16 weights; ``dtype``
    replaces the weights' dtype (``torch.float32``: the float32 masters of
    training, every parameter in float32)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    out = {}
    for k, (shp, _) in param_entries(cfg).items():
        law = init_law(k, shp)
        dt = param_dtype(cfg, k, shp)
        if dtype is not None and dt != torch.float32:
            dt = dtype
        t = torch.zeros(shp, dtype=dt, device=dev)
        if law == "log_uniform":
            u = torch.rand(shp, generator=gen, device=dev, dtype=torch.float64)
            t.copy_(torch.log(1.0 + 15.0 * u))
        elif law == "normal":
            fan_in = shp[-2] if len(shp) >= 2 else shp[-1]
            std = 1.0 / math.sqrt(max(fan_in, 1))
            for part in (t.view(-1, *shp[-2:]) if len(shp) > 2 else [t]):
                part.copy_(torch.randn(part.shape, generator=gen, device=dev)
                           * std)
        out[k] = t
    return out


def _sub(params: Dict[str, torch.Tensor], prefix: str
         ) -> Dict[str, torch.Tensor]:
    pl = len(prefix)
    return {k[pl:]: v for k, v in params.items() if k.startswith(prefix)}


def layer(stack: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s parameters: views of the stacked ``(L, …)`` tensors."""
    return {k: v[i] for k, v in stack.items()}


def layers(stack: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """Every layer's parameters as views (``unbind``): under autograd one
    node per stacked tensor, whose backward stacks the layers' gradients
    once, where a view ``p[l]`` per layer would each scatter into a zero
    tensor of the whole stack."""
    names = list(stack)
    return [dict(zip(names, vals))
            for vals in zip(*(stack[k].unbind(0) for k in names))]


# ---------------------------------------------------------------------------
# Blocks (prefill / forward)
# ---------------------------------------------------------------------------


def _attention_sublayer(p, x, cfg: ModelConfig, positions, *, causal=True,
                        window=0, prefix_len=0, context=None):
    """Self-attention of one block, or with ``context`` (B, T, d) the
    decoder's cross-attention: the ``lnx``/``xq``/``xkv``/``xo`` weights,
    K/V from ``context``, no RoPE, not causal, the KV chunk fitted to T.
    The reference repeats K/V to the full head count so that one head axis
    shards over its mesh; the port keeps the KV heads (the same arithmetic:
    query head h reads KV head h // G)."""
    B, S, d = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cross = context is not None
    h = rms_norm(x, p["lnx" if cross else "ln1"])
    q = (h @ p["xq" if cross else "wq"].to(x.dtype)).reshape(B, S, H, hd)
    src = context if cross else h
    T = src.shape[1]
    kv = (src @ p["xkv" if cross else "wkv"].to(x.dtype)).reshape(
        B, T, 2, KV, hd)
    k, v = kv[:, :, 0], kv[:, :, 1]
    if not cross:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = flash_attention_cv(q, k, v, bool(causal and not cross),
                           int(window or 0), float(cfg.attn_softcap),
                           fit_chunk(S, cfg.q_chunk),
                           fit_chunk(T, cfg.kv_chunk), int(prefix_len))
    out = o.reshape(B, S, H * hd) @ p["xo" if cross else "wo"].to(x.dtype)
    return out.to(x.dtype)


def _dense_block(p, x, cfg: ModelConfig, positions, window=0, prefix_len=0):
    a = _attention_sublayer(p, x, cfg, positions, window=window,
                            prefix_len=prefix_len)
    if cfg.family == "gemma2":
        a = rms_norm(a, p["ln1_post"])
    x = x + a
    h = rms_norm(x, p["ln2"])
    m = swiglu(h, p["w_gate"].to(x.dtype), p["w_up"].to(x.dtype),
               p["w_down"].to(x.dtype)).to(x.dtype)
    if cfg.family == "gemma2":
        m = rms_norm(m, p["ln2_post"])
    return x + m


def _moe_block(p, x, cfg: ModelConfig, positions
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention, then the expert FFN (plus arctic's dense residual FFN on
    the same normed input); returns (x', the layer's aux loss)."""
    x = x + _attention_sublayer(p, x, cfg, positions)
    h = rms_norm(x, p["ln2"])
    out, aux = moe_ffn_auto(_sub(p, "moe_"), h, cfg.moe_dims)
    if cfg.dense_residual:
        out = out + swiglu(h, p["res_w_gate"].to(x.dtype),
                           p["res_w_up"].to(x.dtype),
                           p["res_w_down"].to(x.dtype))
    return x + out, aux


def _decoder_block(p, x, cfg: ModelConfig, positions, context):
    """encdec's decoder layer: causal self-attention, cross-attention to
    the encoder's output, then the MLP (no post norms)."""
    x = x + _attention_sublayer(p, x, cfg, positions)
    x = x + _attention_sublayer(p, x, cfg, positions, context=context)
    return x + swiglu(rms_norm(x, p["ln2"]), p["w_gate"].to(x.dtype),
                      p["w_up"].to(x.dtype), p["w_down"].to(x.dtype))


def _mamba_layer(p, x, cfg: ModelConfig):
    return x + mamba2_block(p, x, cfg.ssm_dims, chunk=cfg.ssd_chunk)


def _zamba_group(mamba_p, shared, gate, x, cfg: ModelConfig, positions):
    """``mamba_per_attn`` SSM layers, then the shared attention+MLP block,
    mixed back in through ``sigmoid(gate)`` (the group's (d,) gate)."""
    for p in layers(mamba_p):
        x = _mamba_layer(p, x, cfg)
    sh = _dense_block(shared, x, cfg, positions)
    mix = torch.sigmoid(gate.float()).to(x.dtype)[None, None, :]
    return x + mix * (sh - x)


def _embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor
                  ) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(cfg.compute_dtype)
    if cfg.embed_scale:
        # sqrt(d) rounded to the compute dtype first, as the reference does
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cfg.compute_dtype,
                             device=x.device)
    return x


def _tail_stack(params: Dict[str, torch.Tensor], cfg: ModelConfig
                ) -> Dict[str, torch.Tensor]:
    """zamba2's ``n_zamba_tail`` trailing SSM layers (the stack holds at
    least one, unused when the tail is empty)."""
    return {k: v[:cfg.n_zamba_tail] for k, v in _sub(params, "tail.").items()}


def forward_hidden(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                   batch: Dict[str, torch.Tensor], *,
                   _blocks: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward: returns (final hidden (B,S,d), moe aux loss).
    ``batch["tokens"]`` (B, S); ``encdec`` and ``vlm`` also take
    ``batch["frontend"]`` (B, n_frontend_tokens, d): the encoder's frames
    or the prepended patch embeddings (vlm's hidden is (B, Np + S, d)).

    ``_blocks`` (the dry-run's depth cut) runs only the first ``_blocks``
    blocks of the full-depth parameters: layers, gemma2's local+global
    pairs, zamba2's groups (its tail runs whole), encdec's encoder and
    decoder layers."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    remat = cfg.remat and torch.is_grad_enabled()

    def run(fn, *args):
        if remat:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def positions(n, dev):
        return torch.arange(n, device=dev)[None].expand(B, n)

    def blocks(stack, per_block=1):
        ls = layers(stack)
        return ls if _blocks is None else ls[:_blocks * per_block]

    fam = cfg.family
    if fam in ("encdec", "vlm") and "frontend" not in batch:
        raise KeyError(
            f"frontend: family {fam!r} ({cfg.name}) needs batch['frontend'], "
            f"its {cfg.frontend} embeddings (B, {cfg.n_frontend_tokens}, "
            f"{cfg.d_model})")
    aux = None
    if fam == "encdec":
        enc = batch["frontend"].to(cfg.compute_dtype)         # (B,Tf,d)
        enc_pos = positions(enc.shape[1], enc.device)
        for p in blocks(_sub(params, "enc.")):
            enc = run(lambda h, p=p: _dense_block(p, h, cfg, enc_pos), enc)
        enc_out = rms_norm(enc, params["enc_final_norm"])
        x = _embed_tokens(params, cfg, tokens)
        pos = positions(S, x.device)
        for p in blocks(_sub(params, "dec.")):
            x = run(lambda h, c, p=p: _decoder_block(p, h, cfg, pos, c),
                    x, enc_out)
    elif fam == "vlm":
        fe = batch["frontend"].to(cfg.compute_dtype)          # (B,Np,d)
        x = torch.cat([fe, _embed_tokens(params, cfg, tokens)], dim=1)
        pos = positions(x.shape[1], x.device)
        for p in blocks(_sub(params, "blocks.")):
            x = run(lambda h, p=p: _dense_block(
                p, h, cfg, pos, prefix_len=cfg.prefix_len), x)
    elif fam == "mamba2":
        x = _embed_tokens(params, cfg, tokens)
        for p in blocks(_sub(params, "blocks.")):
            x = run(lambda h, p=p: _mamba_layer(p, h, cfg), x)
    elif fam == "zamba2":
        x = _embed_tokens(params, cfg, tokens)
        pos = positions(S, x.device)
        shared = _sub(params, "shared.")
        for gp, g in zip(blocks(_sub(params, "blocks.")),
                         params["gate"].unbind(0)):
            x = run(lambda h, gp=gp, g=g: _zamba_group(gp, shared, g, h, cfg,
                                                       pos), x)
        if cfg.n_zamba_tail > 0:
            for p in layers(_tail_stack(params, cfg)):
                x = run(lambda h, p=p: _mamba_layer(p, h, cfg), x)
    elif fam == "moe":
        x = _embed_tokens(params, cfg, tokens)
        pos = positions(S, x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for p in blocks(_sub(params, "blocks.")):
            x, a = run(lambda h, p=p: _moe_block(p, h, cfg, pos), x)
            aux = aux + a
    elif fam in ("dense", "gemma2"):
        x = _embed_tokens(params, cfg, tokens)
        pos = positions(S, x.device)
        for i, p in enumerate(blocks(_sub(params, "blocks."),
                                     2 if fam == "gemma2" else 1)):
            # gemma2: even layers local (sliding window), odd layers global
            win = cfg.window if fam == "gemma2" and i % 2 == 0 else 0
            x = run(lambda h, p=p, win=win: _dense_block(
                p, h, cfg, pos, window=win), x)
    else:
        raise ValueError(fam)
    x = rms_norm(x, params["final_norm"])
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux


def _xent_chunk(xi: torch.Tensor, embed: torch.Tensor, ti: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """One loss chunk: (summed masked NLL, count of non-PAD targets)."""
    logits = softcap((xi @ embed.to(xi.dtype).T).float(), cfg.final_softcap)
    mask = (ti != PAD_ID).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, ti[..., None].long(), dim=-1)[..., 0]
    return ((logz - gold) * mask).sum(), mask.sum()


def _chunked_xent(x: torch.Tensor, embed: torch.Tensor, targets: torch.Tensor,
                  cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy streamed over ``cfg.loss_chunk`` sequence chunks: only
    one chunk's (B, C, V) logits exist at a time, and under autograd each
    chunk is recomputed in the backward (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint(nothing_saveable)``)."""
    S = x.shape[1]
    C = fit_chunk(S, cfg.loss_chunk)
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(S // C):
        xi, ti = x[:, c * C:(c + 1) * C], targets[:, c * C:(c + 1) * C]
        if torch.is_grad_enabled():
            nll, n = checkpoint(_xent_chunk, xi, embed, ti, cfg,
                                use_reentrant=False)
        else:
            nll, n = _xent_chunk(xi, embed, ti, cfg)
        nll_sum, cnt = nll_sum + nll, cnt + n
    return nll_sum, cnt


def forward_train(params: Dict[str, torch.Tensor], cfg: ModelConfig,
                  batch: Dict[str, torch.Tensor], *,
                  _blocks: Optional[int] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (loss, metrics). batch: tokens/targets (B, S) (+ frontend
    embeddings for encdec and vlm).  vlm's ``n_frontend_tokens`` prefix
    positions get ``PAD_ID`` targets, so ``metrics["tokens"]`` counts the
    text targets only; moe's loss is the NLL plus ``0.01 · aux_loss``,
    ``metrics["loss"]`` the NLL alone.  ``_blocks``: as
    :func:`forward_hidden`'s."""
    x, aux_total = forward_hidden(params, cfg, batch, _blocks=_blocks)
    targets = batch["targets"]
    if cfg.family == "vlm":
        # frontend positions carry no next-token target
        pad = torch.full((targets.shape[0], cfg.n_frontend_tokens), PAD_ID,
                         dtype=targets.dtype, device=targets.device)
        targets = torch.cat([pad, targets], dim=1)
    nll_sum, cnt = _chunked_xent(x, params["embed"], targets, cfg)
    loss = nll_sum / torch.clamp(cnt, min=1.0)
    metrics = {"loss": loss, "aux_loss": aux_total, "tokens": cnt}
    if cfg.family == "moe":
        loss = loss + 0.01 * aux_total
    return loss, metrics
