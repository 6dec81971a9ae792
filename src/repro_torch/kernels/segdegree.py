"""Segment-degree statistics of a sorted key column: CUDA kernel + plain version.

:func:`segdegree` returns ``(distinct_count, max_degree)`` of a sorted 1-D
int32 or int64 key column: the number of runs of equal keys and the length
of the longest.  Replaces the Pallas kernel
``repro/kernels/segdegree.py::segdegree_kernel``.

A wrapper given a CPU tensor runs the plain PyTorch version (run-start
arithmetic); given a CUDA tensor it launches the one-pass kernel of
``csrc/segdegree.cu`` on the current stream (one wave of CTAs; the last CTA
to finish merges the others' summaries) or raises.  Either way the two
numbers come back to the host in one sync, as the reference's
``np.asarray`` does.  Each non-empty call adds one kernel to
``build.launch_counts["segdegree"]``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from .build import launch, load, stream


def _check(keys: torch.Tensor) -> None:
    if keys.dim() != 1 or keys.dtype not in (torch.int32, torch.int64):
        raise ValueError("segdegree: keys must be a 1-D int32 or int64 tensor, "
                         f"got {tuple(keys.shape)} {keys.dtype}")
    if not keys.is_contiguous():
        raise ValueError("segdegree: keys must be contiguous")


def segdegree_plain(keys: torch.Tensor) -> Tuple[int, int]:
    """Position i starts a run when ``i == 0 or keys[i] != keys[i-1]``; the
    run lengths are the differences of consecutive start positions."""
    n = keys.shape[0]
    if n == 0:
        return 0, 0
    starts = torch.ones(n, dtype=torch.bool, device=keys.device)
    starts[1:] = keys[1:] != keys[:-1]
    pos = torch.nonzero(starts).flatten()
    lengths = torch.diff(pos, append=pos.new_full((1,), n))
    return int(pos.shape[0]), int(lengths.max())


def segdegree(keys: torch.Tensor) -> Tuple[int, int]:
    """``(distinct_count, max_degree)``; ``keys`` sorted ascending."""
    _check(keys)
    dev = keys.device
    if dev.type == "cpu":
        return segdegree_plain(keys)
    if dev.type != "cuda":
        raise ValueError(f"segdegree: unsupported device {dev}")
    n = keys.shape[0]
    if n == 0:
        return 0, 0
    wave = kernel_wave(keys.element_size(), dev)
    nbytes = load().repro_segdegree_scratch_bytes(wave)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    # int64 on the device until the fetch: counts past 2^31 - 1 stay exact
    out = torch.empty(2, dtype=torch.int64, device=dev)
    launch("segdegree",
           "repro_segdegree_" + ("i32" if keys.dtype == torch.int32 else "i64"),
           keys.data_ptr(), n, wave, scratch.data_ptr(), nbytes,
           out.data_ptr(), stream(dev))
    distinct, longest = out.tolist()
    return distinct, longest


@functools.lru_cache(maxsize=None)
def kernel_wave(key_bytes: int, dev: torch.device) -> int:
    """CTAs of one wave of the kernel for ``key_bytes``-wide keys on ``dev``
    (a call of n keys launches at most this many, each of an equal range)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        wave = load().repro_segdegree_wave(key_bytes, sms)
    if wave <= 0:
        raise RuntimeError(f"segdegree: occupancy query failed with CUDA "
                           f"error {-wave}")
    return wave


def cta_keys(n: int, key_bytes: int, dev: torch.device) -> int:
    """Keys of each CTA's range in a call of ``n`` keys: CTA c reads
    ``[c * k, (c + 1) * k)``."""
    return load().repro_segdegree_cta_keys(n, kernel_wave(key_bytes, dev))
