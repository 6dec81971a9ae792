"""Optimizers of the port: AdamW and Adafactor (factored second moment).

The port's copy of the reference's ``repro/train/optimizer.py``, on plain
dicts of tensors (the state mirrors the parameter dict under the names of
:func:`opt_state_entries`).  AdamW keeps float32 ``m``/``v`` (optionally a
bf16 ``m``).  Adafactor factorises the second moment of every >= 2-D
parameter into row and column statistics ``vr``/``vc`` (Shazeer & Stern,
arXiv:1804.04235), the default for arctic-480b and mistral-large-123b.

The arithmetic is the reference's, in float32: the gradient and ``m`` are
cast to float32 first, ``b1**t`` and ``b2**t`` are float32 tensors of the
float32 step count ``t = step + 1`` (as the reference's traced ``t``), and
each new parameter is cast back to its own dtype.  The reference's
``apply_update`` returns new dicts; :func:`apply_update_` writes the same
values into the parameters and slots it is given, piece by piece, so a
train step holds one optimizer state, not two.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"                 # "adamw" | "adafactor"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    m_dtype: str = "float32"            # "bfloat16" halves first-moment memory
    min_dim_factored: int = 2           # adafactor: factor dims >= 2


def default_opt_for(model_name: str) -> OptConfig:
    if any(t in model_name for t in ("arctic", "mistral-large")):
        return OptConfig(kind="adafactor")
    return OptConfig()


def opt_state_entries(opt: OptConfig, shapes: Dict[str, Tuple[int, ...]]
                      ) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """name -> (shape, role) for optimizer slots; role keys sharding reuse."""
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    for k, shp in shapes.items():
        if opt.kind == "adamw":
            out[f"m.{k}"] = (shp, k)
            out[f"v.{k}"] = (shp, k)
        else:
            out[f"m.{k}"] = (shp, k)
            if len(shp) >= opt.min_dim_factored:
                out[f"vr.{k}"] = (shp[:-1], k)          # row stats
                out[f"vc.{k}"] = (shp[:-2] + shp[-1:], k)  # col stats
            else:
                out[f"v.{k}"] = (shp, k)
    return out


def m_dtype(opt: OptConfig) -> torch.dtype:
    return torch.bfloat16 if opt.m_dtype == "bfloat16" else torch.float32


def init_opt_state(opt: OptConfig, params: Tensors) -> Tensors:
    """Zero slots on the parameters' device."""
    dev = next(iter(params.values())).device
    out = {}
    for k, (shp, _) in opt_state_entries(
            opt, {k: tuple(v.shape) for k, v in params.items()}).items():
        out[k] = torch.zeros(shp, dtype=m_dtype(opt) if k.startswith("m.")
                             else torch.float32, device=dev)
    return out


def _update(opt: OptConfig, p: torch.Tensor, g: torch.Tensor,
            slots: Tensors, decay: bool, eff_lr, bc1, bc2
            ) -> Tuple[torch.Tensor, Tensors]:
    """One parameter's new value and new slots (keyed ``m``/``v`` or
    ``m``/``vr``/``vc``), each in its own dtype.  Elementwise but for
    adafactor's row and column means over the last two dims."""
    g = g.float()
    m = opt.b1 * slots["m"].float() + (1 - opt.b1) * g
    new = {"m": m.to(slots["m"].dtype)}
    if "vr" in slots:
        g2 = g * g + 1e-30
        vr = opt.b2 * slots["vr"] + (1 - opt.b2) * g2.mean(dim=-1)
        vc = opt.b2 * slots["vc"] + (1 - opt.b2) * g2.mean(dim=-2)
        # factored reconstruction: vr ⊗ vc / mean(vr)
        denom = torch.clamp(vr.mean(dim=-1, keepdim=True), min=1e-30)
        vhat = (vr[..., :, None] * vc[..., None, :]) / denom[..., None]
        upd = m / (torch.sqrt(vhat / bc2) + opt.eps)
        new.update(vr=vr, vc=vc)
    else:
        v = opt.b2 * slots["v"] + (1 - opt.b2) * g * g
        if opt.kind == "adamw":
            upd = (m / bc1) / (torch.sqrt(v / bc2) + opt.eps)
        else:
            upd = m / (torch.sqrt(v / bc2) + opt.eps)
        new["v"] = v
    if decay:
        upd = upd + opt.weight_decay * p
    return (p - eff_lr * upd).to(p.dtype), new


# elements per piece of apply_update_: its float32 temporaries (the cast
# gradient, m, v, the update, the new value) for one piece at a time
UPDATE_PIECE = 1 << 25


def _pieces(shape, factored: bool) -> list:
    """Views that cut a tensor of ``shape`` into the update's pieces: flat
    ranges of ``UPDATE_PIECE`` elements where the update is elementwise,
    ranges of dim 0 where adafactor factors a >= 3-d tensor (its means
    stay within a slice), the whole tensor otherwise."""
    n = math.prod(shape)
    if not factored:
        return [lambda t, i=i: t.view(-1)[i:i + UPDATE_PIECE]
                for i in range(0, n, UPDATE_PIECE)]
    if len(shape) < 3:
        return [lambda t: t]
    per = max(1, UPDATE_PIECE // max(n // shape[0], 1))
    return [lambda t, i=i: t[i:i + per] for i in range(0, shape[0], per)]


def apply_update_(opt: OptConfig, params: Tensors, grads: Tensors,
                  state: Tensors, step: torch.Tensor,
                  lr: Optional[torch.Tensor] = None) -> None:
    """One optimizer step, in place: each parameter and slot is
    overwritten piece by piece (elementwise arithmetic, so the pieces give
    the whole tensor's bits), holding the temporaries of one piece.
    Parameters and slots must be contiguous.  ``lr`` (a tensor) overrides
    ``opt.lr``: Adam-family updates are invariant to gradient scaling, so
    schedules scale the update, never the gradients."""
    eff_lr = opt.lr if lr is None else lr
    t = torch.as_tensor(step, device=next(iter(params.values())).device
                        ).float() + 1.0
    bc1, bc2 = 1 - opt.b1 ** t, 1 - opt.b2 ** t
    for k, p in params.items():
        factored = f"vr.{k}" in state
        slots = {r: state[f"{r}.{k}"]
                 for r in (("m", "vr", "vc") if factored else ("m", "v"))}
        g = grads[k].contiguous()
        for cut in _pieces(tuple(p.shape), factored):
            new_p, new = _update(opt, cut(p), cut(g),
                                 {r: cut(v) for r, v in slots.items()},
                                 p.dim() >= 2, eff_lr, bc1, bc2)
            cut(p).copy_(new_p)
            for r, v in new.items():
                cut(slots[r]).copy_(v)


def global_norm(tree: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(v.float()))
                          for v in tree.values()))


def clip_by_global_norm(grads: Tensors, max_norm: float
                        ) -> Tuple[Tensors, torch.Tensor]:
    """Scale every gradient by ``min(1, max_norm / norm)``, computed in
    float32 and cast back to the gradient's dtype (the reference multiplies
    a bf16 gradient by a float32 scale in float32)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return {k: (v.float() * scale).to(v.dtype) for k, v in grads.items()}, gn
