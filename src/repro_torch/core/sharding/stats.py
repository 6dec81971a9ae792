"""Statistic merges across the mesh — the associative algebra behind
cross-rank estimation.

Port of ``repro.core.sharding.stats`` on ``torch.distributed``.  Every
statistic the estimation layer keeps (``RunningMean`` on the host,
``TorchRunning`` on the device) is a moment triple ``(count, mean, M2)``
whose merge is associative (Chan et al.), so wander-join statistics from
many ranks combine into one global estimate with sum-reductions:
:func:`psum_merge_moments` is the collective form (the estimator's mesh
path), :func:`merge_moment_stack` the reference over stacked per-rank
moments that the tests compare against (and
:func:`repro_torch.core.distributed.merge_statistics`'s device twin).

Counters merge with a plain sum: :func:`psum_counters` merges per-rank
``SamplerStats``-style counter vectors.  The sharded union loop derives its
global counters from the one all-gather its round already performs, so it
needs no second collective.

At world 1 (``mesh.group is None``) a sum over the mesh is the identity and
no collective runs; the arithmetic stays the same.
"""

from __future__ import annotations

from typing import Tuple

import torch

Moments = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # (count, mean, M2)


def _psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum of ``x`` over the mesh's ranks (every rank gets the sum)."""
    if mesh.group is None:
        return x
    import torch.distributed as dist
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def psum_merge_moments(n: torch.Tensor, mean: torch.Tensor, m2: torch.Tensor,
                       mesh) -> Moments:
    """Merge per-rank Welford moments across the mesh: three ``all_reduce``
    sums.

    Uses the pooled-moments identity
    ``M2 = Σ_s M2_s + Σ_s n_s (mean_s - mean)²`` in the reference's float32
    order — algebraically identical to folding the ranks sequentially with
    Chan's merge, but order-free.  Elementwise, so stacked triples (e.g. a
    size and an overlap accumulator) merge in the same three reductions.
    Every rank returns the same merged triple."""
    nf = n.to(torch.float32)
    total = _psum(n, mesh)
    totalf = torch.clamp(total.to(torch.float32), min=1.0)
    gmean = _psum(nf * mean, mesh) / totalf
    gm2 = _psum(m2 + nf * (mean - gmean) ** 2, mesh)
    return total, gmean, gm2


def psum_counters(vec: torch.Tensor, mesh) -> torch.Tensor:
    """Merge per-rank integer counter vectors across the mesh (one sum)."""
    return _psum(vec, mesh)


def merge_moment_stack(n: torch.Tensor, mean: torch.Tensor, m2: torch.Tensor
                       ) -> Moments:
    """Reference: merge stacked per-rank moments ``(world,)`` → one.

    The pooled-moments identity of :func:`psum_merge_moments` with the
    collective replaced by an axis-0 sum."""
    nf = n.to(torch.float32)
    total = torch.sum(n)
    totalf = torch.clamp(total.to(torch.float32), min=1.0)
    gmean = torch.sum(nf * mean) / totalf
    gm2 = torch.sum(m2 + nf * (mean - gmean) ** 2)
    return total, gmean, gm2
