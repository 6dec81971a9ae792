"""Sharded execution layer on ``torch.distributed`` (port of
``repro.core.sharding``).

``ShardedCatalog`` gives each rank its part of a union's state (replicated
draw state, hash-partitioned membership fingerprints, row-range stores);
``ShardedUnionSampler`` runs the Algorithm-1 round across the ranks with one
fingerprint exchange per round.  ``SetUnionSampler(mesh=...)`` is the
façade entry point; :func:`make_sampler_mesh` builds the mesh.
"""

from __future__ import annotations

from .catalog import (SamplerMesh, ShardedCatalog, ShardedMembership,
                      ShardedTreeJoin, make_sampler_mesh, owned_fingerprints,
                      partition_of_fp32, rank_stream_seed, row_range_bounds)
from .sampler import ShardedUnionSampler
from .stats import merge_moment_stack, psum_counters, psum_merge_moments

__all__ = [
    "SamplerMesh", "ShardedCatalog", "ShardedMembership", "ShardedTreeJoin",
    "ShardedUnionSampler", "make_sampler_mesh", "merge_moment_stack",
    "owned_fingerprints", "partition_of_fp32", "psum_counters",
    "psum_merge_moments", "rank_stream_seed", "row_range_bounds",
]
