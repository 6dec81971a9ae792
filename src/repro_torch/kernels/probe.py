"""Sorted-key range probe and fused probe-and-pick: CUDA kernels + plain versions.

* :func:`sorted_probe` — ``(lo, hi) = (#keys < q, #keys <= q)`` per query
  against a sorted int32 or int64 key column.  Replaces the Pallas pipeline
  ``repro/kernels/searchsorted.py`` (``fence_count_kernel`` +
  ``refine_kernel``).
* :func:`probe_pick` — the same search, then ``d = hi - lo`` and the ranged
  uniform pick ``pos = lo + min(floor(u·max(d,1)), max(d-1,0))`` in float32.
  Replaces ``repro/kernels/walk.py::hop_refine_pick_kernel``.

Outputs are int32 in ``[0, n]`` (``pos`` is not clipped: a dead query,
``d == 0``, gets ``pos = lo``).  A wrapper given CPU tensors runs the plain
PyTorch version (``torch.searchsorted`` + the same float32 pick); given CUDA
tensors it launches the kernel of ``csrc/probe.cu`` on the current stream or
raises.  Each kernel launch adds one to :data:`launch_counts`, the counter
that every kernel of the port shares (``build.launch_counts``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from .build import launch, launch_counts, reset_launch_counts, stream  # noqa: F401


def _check(keys: torch.Tensor, queries: torch.Tensor) -> None:
    if keys.dim() != 1 or queries.dim() != 1:
        raise ValueError("sorted probe: keys and queries must be 1-D, got "
                         f"{tuple(keys.shape)} and {tuple(queries.shape)}")
    if keys.dtype not in (torch.int32, torch.int64) or queries.dtype != keys.dtype:
        raise ValueError("sorted probe: keys and queries must share dtype "
                         f"int32 or int64, got {keys.dtype} / {queries.dtype}")
    if keys.device != queries.device:
        raise ValueError(f"sorted probe: keys on {keys.device}, queries on "
                         f"{queries.device}")
    if not (keys.is_contiguous() and queries.is_contiguous()):
        raise ValueError("sorted probe: keys and queries must be contiguous")
    if keys.shape[0] >= 1 << 31:
        raise ValueError("sorted probe: more than 2^31 - 1 keys")


def _suffix(keys: torch.Tensor) -> str:
    return "i32" if keys.dtype == torch.int32 else "i64"


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path; the card's comparison target)
# ---------------------------------------------------------------------------


def sorted_probe_plain(keys: torch.Tensor, queries: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    lo = torch.searchsorted(keys, queries, side="left").to(torch.int32)
    hi = torch.searchsorted(keys, queries, side="right").to(torch.int32)
    return lo, hi


def pick_from_range(lo: torch.Tensor, d: torch.Tensor, u: torch.Tensor
                    ) -> torch.Tensor:
    """``lo + min(floor(u·max(d,1)), max(d-1,0))`` in float32 (int32 out)."""
    off = torch.floor(u * torch.clamp(d, min=1).to(torch.float32)).to(torch.int32)
    return lo + torch.minimum(off, torch.clamp(d - 1, min=0))


def probe_pick_plain(keys: torch.Tensor, queries: torch.Tensor,
                     u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    lo, hi = sorted_probe_plain(keys, queries)
    d = hi - lo
    return pick_from_range(lo, d, u), d


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def sorted_probe(keys: torch.Tensor, queries: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lo, hi)`` int32 per query; ``keys`` sorted ascending."""
    _check(keys, queries)
    dev = keys.device
    if dev.type == "cpu":
        return sorted_probe_plain(keys, queries)
    if dev.type != "cuda":
        raise ValueError(f"sorted_probe: unsupported device {dev}")
    nq = queries.shape[0]
    lo = torch.empty(nq, dtype=torch.int32, device=dev)
    hi = torch.empty(nq, dtype=torch.int32, device=dev)
    if nq == 0:
        return lo, hi
    launch("sorted_probe", "repro_sorted_probe_" + _suffix(keys),
           keys.data_ptr(), keys.shape[0], queries.data_ptr(), nq,
           lo.data_ptr(), hi.data_ptr(), stream(dev))
    return lo, hi


def probe_pick(keys: torch.Tensor, queries: torch.Tensor, u: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(pos, d)`` int32 per query; ``u`` float32 uniforms in [0, 1)."""
    _check(keys, queries)
    if (u.dtype != torch.float32 or u.shape != queries.shape
            or u.device != queries.device or not u.is_contiguous()):
        raise ValueError("probe_pick: u must be a contiguous float32 tensor "
                         "shaped and placed like queries")
    dev = keys.device
    if dev.type == "cpu":
        return probe_pick_plain(keys, queries, u)
    if dev.type != "cuda":
        raise ValueError(f"probe_pick: unsupported device {dev}")
    nq = queries.shape[0]
    pos = torch.empty(nq, dtype=torch.int32, device=dev)
    deg = torch.empty(nq, dtype=torch.int32, device=dev)
    if nq == 0:
        return pos, deg
    launch("probe_pick", "repro_probe_pick_" + _suffix(keys),
           keys.data_ptr(), keys.shape[0], queries.data_ptr(), u.data_ptr(),
           nq, pos.data_ptr(), deg.data_ptr(), stream(dev))
    return pos, deg
