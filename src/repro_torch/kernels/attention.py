"""One-token GQA decode attention: CUDA kernel + plain version.

:func:`decode_attention` takes ``q (B, H, D)``, ``k``/``v (B, S, KVH, D)`` and
``lengths (B,)`` and returns ``(B, H, D)`` in q's dtype: query head ``h``
attends to KV head ``h // (H // KVH)`` over positions ``s < lengths[b]``
(and ``s >= lengths[b] - window`` when ``window > 0``), with logits
``(q . k) * scale`` (``scale`` defaults to ``1/sqrt(D)``), optionally
``softcap * tanh(logits / softcap)``, and an fp32 softmax whose denominator
is ``max(l, 1e-30)``, so a row of length 0 gives zeros.  f32 or bf16 inputs.
Replaces the Pallas kernel ``repro/kernels/attention.py::decode_attn_kernel``.

A wrapper given CPU tensors runs the plain PyTorch version; given CUDA
tensors it launches the kernels of ``csrc/attention.cu`` on the current
stream (D in {16, 64, 112, 128, 256}, 1 to 48 query heads per KV head) or
raises.  Each call adds the kernels it launched (2: the plan, which cuts
the kept rows of every work item, a (b, kv head) pair and at most 8 of its
query heads, into one balanced run of tiles per CTA on the device, then
the attention kernel, which also merges the items that span CTAs) to
``build.launch_counts["decode_attention"]``.

The call goes through the dispatcher as the operator
``torch.ops.repro_torch.decode_attention``: its CPU implementation is the
plain version, its CUDA implementation the launch, and its Meta
implementation gives ``q``'s shape and dtype, so a step traced on meta
tensors (:mod:`repro_torch.launch.dryrun`; the kernel's shape checks hold
there as on the card) reaches B4 by name, launches nothing and counts
``4·B·H·min(S, window or S)·D`` FLOPs for it (``torch.utils.flop_counter``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.utils.flop_counter import register_flop_formula

from .build import launch, load, stream

MASKED = -1e30      # the reference's masked logit
KERNEL_HEAD_DIMS = (16, 64, 112, 128, 256)
KERNEL_MAX_GROUP = 48


def _check(q, k, v, lengths) -> None:
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError("decode_attention: q must be (B, H, D) and k, v "
                         f"(B, S, KVH, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2] != 0:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} does not fit "
                         f"k {tuple(k.shape)} (H must be a multiple of KVH)")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            q.dtype == k.dtype == v.dtype):
        raise ValueError("decode_attention: q, k, v must share dtype float32 "
                         f"or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.shape != (B,):
        raise ValueError(f"decode_attention: lengths must be ({B},), got "
                         f"{tuple(lengths.shape)}")
    if not (q.device == k.device == v.device == lengths.device):
        raise ValueError("decode_attention: q, k, v and lengths must share a "
                         "device")


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, scale: Optional[float] = None,
                           softcap: float = 0.0, window: int = 0
                           ) -> torch.Tensor:
    B, H, D = q.shape
    S, KVH = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    qg = q.float().reshape(B, KVH, H // KVH, D)
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * scale
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    spos = torch.arange(S, device=q.device)[None, :]
    lens = lengths.to(torch.int64)[:, None]
    mask = spos < lens
    if window > 0:
        mask &= spos >= lens - window
    mask = mask[:, None, None, :]
    logits = torch.where(mask, logits, MASKED)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = torch.where(mask, p, 0.0)
    p = p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return out.reshape(B, H, D).to(q.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, scale: Optional[float] = None,
                     softcap: float = 0.0, window: int = 0) -> torch.Tensor:
    """q (B,H,D), k/v (B,S,KVH,D), lengths (B,) -> (B,H,D) in q's dtype."""
    _check(q, k, v, lengths)
    dev = q.device
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"decode_attention: unsupported device {dev}")
    if dev.type != "cpu":       # the card, or a traced step of it (meta)
        H, D = q.shape[1], q.shape[2]
        if D not in KERNEL_HEAD_DIMS or H // k.shape[2] > KERNEL_MAX_GROUP:
            raise ValueError(
                f"decode_attention: the kernel takes D in {KERNEL_HEAD_DIMS} "
                f"and at most {KERNEL_MAX_GROUP} query heads per KV head, got "
                f"D={D}, G={H // k.shape[2]}")
        if window < 0:
            raise ValueError(f"decode_attention: window {window} < 0")
    return torch.ops.repro_torch.decode_attention(
        q, k, v, lengths, None if scale is None else float(scale),
        float(softcap), int(window))


def _decode_attention_cpu(q, k, v, lengths, scale, softcap, window):
    return decode_attention_plain(q, k, v, lengths, scale=scale,
                                  softcap=softcap, window=window)


def _decode_attention_cuda(q, k, v, lengths, scale, softcap, window):
    """The launch: the plan kernel, then the attention kernel."""
    dev = q.device
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()) or any(
            t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attention: q, k, v must be contiguous and "
                         "16-byte aligned")
    B, H, D = q.shape
    S, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if B == 0:
        return out
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    lens = lengths.to(torch.int32).contiguous()
    bf16 = q.dtype == torch.bfloat16
    ctas = kernel_ctas(H, KVH, D, bf16, dev)
    n_scratch = load().repro_decode_attention_scratch_bytes(B, H, KVH, D, ctas)
    scratch = torch.empty(n_scratch, dtype=torch.uint8, device=dev)
    launch("decode_attention",
           "repro_decode_attention_" + ("bf16" if bf16 else "f32"),
           q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
           B, H, S, KVH, D, float(scale), float(softcap), int(window), ctas,
           scratch.data_ptr(), n_scratch, out.data_ptr(), stream(dev))
    return out


def _decode_attention_meta(q, k, v, lengths, scale, softcap, window):
    return torch.empty_like(q)


# B4 as an operator of the dispatcher, registered with torch.library's
# low-level API: ``torch.library.custom_op`` costs about four times as much
# host time a call (an aliasing check and an autograd wrapper in Python)
# and imports torch.distributed.tensor and dynamo on its first call,
# seconds inside the first served decode step (PERF.md §6).  The
# Meta implementation is what meta and fake tensors run.
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("decode_attention(Tensor q, Tensor k, Tensor v, Tensor lengths, "
            "float? scale, float softcap, int window) -> Tensor")
_LIB.impl("decode_attention", _decode_attention_cpu, "CPU")
_LIB.impl("decode_attention", _decode_attention_cuda, "CUDA")
_LIB.impl("decode_attention", _decode_attention_meta, "Meta")


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _decode_attention_flops(q_shape, k_shape, v_shape, lengths_shape, scale,
                            softcap, window, *args, out_shape=None,
                            **kwargs) -> int:
    """QK^T and PV over the kept positions: 4·B·H·min(S, window or S)·D."""
    B, H, D = q_shape
    S = k_shape[1]
    return 4 * B * H * min(S, window or S) * D


@functools.lru_cache(maxsize=None)
def kernel_ctas(H: int, KVH: int, D: int, bf16: bool, dev: torch.device) -> int:
    """CTAs the attention kernel launches: one wave, as many as the SMs of
    ``dev`` hold at once for this group size, head width and dtype."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        ctas = load().repro_decode_attention_ctas(H, KVH, D, int(bf16), sms)
    if ctas <= 0:
        raise RuntimeError(f"decode_attention: occupancy query failed with "
                           f"CUDA error {-ctas}")
    return ctas
