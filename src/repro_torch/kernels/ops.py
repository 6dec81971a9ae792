"""The port's kernel entry point: the counterpart of ``repro.kernels.ops``.

Same function names and contracts as the reference's module, over the
port's kernels (``probe``, ``segdegree``, ``attention``).  Each function
takes numpy arrays or tensors and an explicit ``device``: ``None`` means the
card (raising without one, see :func:`repro_torch.device.resolve_device`),
``"cpu"`` runs the plain PyTorch versions.  The device is the caller's
choice; nothing here looks for a backend on its own.  Results are tensors on
that device, except :func:`segdegree`'s two Python ints.

``ranged_weighted_pick`` — the Exact-Weight child pick — has no kernel of
its own: non-negative float32 values are order-isomorphic to their int32
bit patterns, so it runs ``sorted_probe`` over the bit patterns of the
float32 prefix sums.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..device import resolve_device
from . import attention as _attention
from . import probe as _probe
from . import segdegree as _segdegree


def _ints(*xs, device: torch.device):
    """Integer columns on ``device``: int32 kept when every input is int32,
    else int64 (as the reference casts to)."""
    ts = [torch.as_tensor(x, device=device) for x in xs]
    dt = torch.int32 if all(t.dtype == torch.int32 for t in ts) else torch.int64
    return [t.to(dt).contiguous() for t in ts]


def searchsorted(keys, queries, device=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lo, hi) = (#keys < q, #keys <= q)`` per query, int32 in [0, n];
    ``keys`` sorted."""
    dev = resolve_device(device)
    k, q = _ints(keys, queries, device=dev)
    return _probe.sorted_probe(k, q)


def walk_hop(keys, queries, u, device=None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One hop: ``(pos, degree)`` per walk, int32, ``pos`` clipped to
    ``n - 1``; ``u`` uniform in [0, 1)."""
    dev = resolve_device(device)
    k, q = _ints(keys, queries, device=dev)
    uu = torch.as_tensor(u, device=dev).to(torch.float32).contiguous()
    pos, deg = _probe.probe_pick(k, q, uu)
    return torch.clamp(pos, max=max(k.shape[0] - 1, 0)), deg


def segdegree(sorted_keys, device=None) -> Tuple[int, int]:
    """``(distinct_count, max_degree)`` of a sorted key column."""
    dev = resolve_device(device)
    (k,) = _ints(sorted_keys, device=dev)
    return _segdegree.segdegree(k)


def decode_attention(q, k, v, lengths, scale: Optional[float] = None,
                     softcap: float = 0.0, window: int = 0, device=None
                     ) -> torch.Tensor:
    """q (B,H,D), k/v (B,S,KVH,D), lengths (B,) -> (B,H,D) in q's dtype."""
    dev = resolve_device(device)
    q, k, v = (torch.as_tensor(x, device=dev).contiguous() for x in (q, k, v))
    lens = torch.as_tensor(lengths, device=dev)
    return _attention.decode_attention(q, k, v, lens, scale=scale,
                                       softcap=softcap, window=window)


def ranged_weighted_pick(cs, lo, hi, u, device=None) -> torch.Tensor:
    """EW pick: position in [lo, hi) with probability ∝ weight, via the
    prefix sums ``cs`` (non-negative, float32-representable, length n+1).
    int64 positions."""
    dev = resolve_device(device)
    cs32 = torch.as_tensor(cs, device=dev).to(torch.float32).contiguous()
    lo, hi = (torch.as_tensor(x, device=dev).to(torch.int64) for x in (lo, hi))
    uu = torch.as_tensor(u, device=dev).to(torch.float32)
    tot = cs32[hi] - cs32[lo]
    tgt = cs32[lo] + uu * torch.clamp(tot, min=1e-30)
    last = torch.nextafter(cs32[-1:], torch.tensor(float("-inf"), device=dev))
    tgt = torch.minimum(tgt, last).contiguous()
    # order-isomorphic bit-cast: non-negative float32 -> int32
    _, le_count = _probe.sorted_probe(cs32.view(torch.int32),
                                      tgt.view(torch.int32))
    pos = le_count.to(torch.int64) - 1
    return torch.clamp(pos, min=lo, max=torch.maximum(hi - 1, lo))
