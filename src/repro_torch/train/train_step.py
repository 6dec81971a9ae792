"""Training step of the port: loss → grads → clip → optimizer, with
μ-batch accumulation.

The port's copy of the reference's ``repro/train/train_step.py``:

* float32 master parameters; the loss is differentiated with respect to
  copies of every parameter in ``cfg.compute_dtype`` (norm scales
  included: the reference's ``p16``), and the masters are updated with the
  float32-cast gradients;
* ``n_microbatches > 1`` splits the batch and accumulates the gradients in
  float32 (the reference's ``lax.scan``: a Python loop here);
* optional value-level int8 error-feedback compression
  (:mod:`repro_torch.train.grad_compress`) before the update;
* LR schedule: linear warm-up → cosine.

The state is ``{"step": int32 0-dim tensor, "params": {...}, "opt":
{...}}`` (+ ``"ef"`` under ``compress_grads``), every tensor on one device;
a step returns the next state and its metrics as tensors (no host sync).
The step consumes the state it is given, as the reference's jitted step
does with donated buffers: the masters and the optimizer slots are updated
in place (:func:`repro_torch.train.optimizer.apply_update_`), so a step
holds one optimizer state, not two; keep a copy to reuse an old state.
:func:`train_state_specs` gives the state's shapes and dtypes as tensors
on the meta device (nothing is allocated, arctic-480b included) and
:func:`train_state_logical_axes` the matching logical axes, for
:func:`repro_torch.launch.sharding.tree_shardings`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models.transformer import (ModelConfig, forward_train, init_params,
                                  logical_axes, param_entries)
from .grad_compress import compress_decompress, init_error_feedback
from .optimizer import (OptConfig, apply_update_, clip_by_global_norm,
                        init_opt_state, m_dtype, opt_state_entries)

State = Dict[str, Any]
Batch = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    max_grad_norm: float = 1.0
    n_microbatches: int = 1
    warmup_steps: int = 100
    total_steps: int = 10_000
    compress_grads: bool = False


def lr_at(tc: TrainConfig, step: torch.Tensor) -> torch.Tensor:
    """The schedule's factor at ``step`` (float32; times ``opt.lr``)."""
    s = torch.as_tensor(step).float()
    # warmup counts from 1 so the first step takes a real update
    warm = torch.clamp((s + 1.0) / max(tc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - tc.warmup_steps)
                       / max(tc.total_steps - tc.warmup_steps, 1), 0, 1)
    return warm * 0.5 * (1 + torch.cos(math.pi * prog))


def make_train_step(cfg: ModelConfig, tc: TrainConfig, *,
                    _blocks: Optional[int] = None
                    ) -> Callable[[State, Batch], Tuple[State, Dict]]:
    """Returns ``train_step(state, batch) -> (state, metrics)``; batch:
    tokens/targets (B, S) on the state's device.  ``_blocks``: as
    :func:`~repro_torch.models.transformer.forward_hidden`'s."""

    def grads_of(params, batch):
        # differentiate wrt compute-dtype copies of every parameter
        p16 = {k: v.detach().to(cfg.compute_dtype).requires_grad_(True)
               for k, v in params.items()}
        loss, metrics = forward_train(p16, cfg, batch, _blocks=_blocks)
        # zeros for a parameter the loss does not reach (arctic's
        # res_ln2), as the reference's grad gives
        grads = torch.autograd.grad(loss, list(p16.values()),
                                    materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(p16, grads)))

    def train_step(state, batch):
        params = state["params"]
        if tc.n_microbatches > 1:
            n = tc.n_microbatches
            acc = {k: torch.zeros(v.shape, dtype=torch.float32,
                                  device=v.device) for k, v in params.items()}
            loss_sum = 0.0
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
                loss, _, grads = grads_of(params, mb)
                for k in acc:
                    acc[k] += grads[k].float()
                loss_sum = loss_sum + loss
                del grads
            grads = {k: v / n for k, v in acc.items()}
            loss = loss_sum / n
            metrics = {"loss": loss}
        else:
            loss, metrics, grads = grads_of(params, batch)

        if tc.compress_grads:
            grads, state = compress_decompress(grads, state)

        grads, gnorm = clip_by_global_norm(grads, tc.max_grad_norm)
        lr = lr_at(tc, state["step"]) * tc.opt.lr
        apply_update_(tc.opt, params, grads, state["opt"], state["step"],
                      lr=lr)
        new_state = dict(state)
        new_state["step"] = state["step"] + 1
        metrics = dict(metrics)
        metrics.update(grad_norm=gnorm, lr=lr)
        return new_state, metrics

    return train_step


def init_train_state(cfg: ModelConfig, tc: TrainConfig, seed: int = 0,
                     device=None) -> State:
    """Float32 masters from :func:`init_params` (drawn per layer, stored in
    float32: no second copy), zero optimizer slots, step 0, on ``device``
    (``None``: the card)."""
    params = init_params(cfg, seed, device=device, dtype=torch.float32)
    dev = next(iter(params.values())).device
    state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
             "params": params, "opt": init_opt_state(tc.opt, params)}
    if tc.compress_grads:
        state["ef"] = init_error_feedback(params)
    return state


def _meta(shape, dtype=torch.float32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_state_specs(cfg: ModelConfig, tc: TrainConfig) -> State:
    """The state's shapes and dtypes as meta tensors: float32 masters, the
    optimizer slots of ``opt_state_entries`` (``m`` in ``m_dtype``;
    adafactor's factored ``vr``/``vc``), ``ef`` under ``compress_grads``."""
    shapes = {k: shp for k, (shp, _) in param_entries(cfg).items()}
    state = {"step": _meta((), torch.int32),
             "params": {k: _meta(shp) for k, shp in shapes.items()},
             "opt": {k: _meta(shp, m_dtype(tc.opt) if k.startswith("m.")
                              else torch.float32)
                     for k, (shp, _) in opt_state_entries(
                         tc.opt, shapes).items()}}
    if tc.compress_grads:
        state["ef"] = {k: _meta(shp) for k, shp in shapes.items()}
    return state


def train_state_logical_axes(cfg: ModelConfig, tc: TrainConfig) -> State:
    """Logical axes matching :func:`train_state_specs`."""
    lax_ = logical_axes(cfg)
    shapes = {k: shp for k, (shp, _) in param_entries(cfg).items()}
    opt_ax = {}
    for k, (shp, role) in opt_state_entries(tc.opt, shapes).items():
        base = lax_[role]
        if len(shp) == len(base):
            opt_ax[k] = base
        elif k.startswith("vr."):
            # factored adafactor slots: drop the reduced dim's logical name
            opt_ax[k] = base[:-1]
        else:  # vc: all but second-to-last
            opt_ax[k] = base[:-2] + base[-1:]
    state = {"step": (), "params": lax_, "opt": opt_ax}
    if tc.compress_grads:
        state["ef"] = lax_
    return state
