"""Rank-partitioned catalog: replicated draw state + hash-partitioned membership.

Port of ``repro.core.sharding.catalog`` on ``torch.distributed``.  The
reference lays a union out over a 1-axis JAX mesh as ``(world, ...)``
stacks, one process's view of every shard; here every rank is a process of
its own and holds only its own shard:

* **the mesh** (:class:`SamplerMesh`, :func:`make_sampler_mesh`) — the
  process group (``None`` at world 1), this rank, the world size and the
  rank's device;
* **replicated candidate roots** (:class:`ShardedTreeJoin`) — every rank
  keeps the whole join's draw state (root weight prefix and payload columns
  plus the non-root node indexes of the underlying
  :class:`~repro_torch.core.backends.torch_backend.TorchTreeJoin`) and draws
  i.i.d. candidates from the whole join on a stream of its own;
* **hash-partitioned membership** (:class:`ShardedMembership`) — the
  row-fingerprint space of every base relation is split by
  :func:`partition_of_fp32`: rank ``r`` indexes only fingerprints with
  ``fp1 % world == r``, so a probe is answered by its owner, and one round
  needs one all-gather and one reduce-scatter (see
  :class:`~repro_torch.core.sharding.sampler.ShardedUnionSampler`);
* **row-range stores** (:meth:`ShardedCatalog.columns_for`) — each
  relation's rows cut into ``world`` contiguous ranges; a rank keeps its own.

With ``world == 1`` every per-rank structure equals the unsharded engine's
tensors bit for bit, and no collective runs.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...device import rank_device
from ..backends.torch_backend import TorchBackend, TorchTreeJoin, _as_i32, fp32
from ..index import Catalog
from ..joins import JoinSpec
from ..relation import Relation

# sort-last pad of an empty rank's index (uint32 all-ones held in int64);
# real hits are guarded by n_owned
_FP_PAD = 0xFFFFFFFF

# the purposes of a rank's own Philox streams (see rank_stream_seed)
DRAW_STREAM, WALK_STREAM = 1, 2


@dataclasses.dataclass(frozen=True)
class SamplerMesh:
    """One rank's view of the sampler mesh: the process group (``None`` at
    world 1, where nothing is exchanged), this rank, the world size and the
    device the rank's tensors live on."""

    world: int
    rank: int
    device: torch.device
    group: Optional[object] = None


def make_sampler_mesh(world: Optional[int] = None, device=None) -> SamplerMesh:
    """The mesh of this process.

    ``world=None`` takes the initialised process group's size, or 1 in a
    process without one.  ``world > 1`` needs ``torch.distributed.
    init_process_group`` to have run with ``world`` ranks (torchrun, or a
    spawn that initialises the group) and raises otherwise: a rank never
    becomes a world of one on its own.  ``device=None`` is the card, indexed
    by ``LOCAL_RANK`` (torchrun's) modulo the visible cards; it raises
    without a card unless ``device="cpu"``."""
    import torch.distributed as dist
    initialised = dist.is_available() and dist.is_initialized()
    if world is None:
        if not initialised and int(os.environ.get("WORLD_SIZE", "1")) > 1:
            raise RuntimeError(
                "make_sampler_mesh: WORLD_SIZE is set but no process group "
                "is initialised; call torch.distributed.init_process_group "
                "first")
        world = dist.get_world_size() if initialised else 1
    world = int(world)
    if world < 1:
        raise ValueError(f"make_sampler_mesh: world must be >= 1, got {world}")
    rank, group = 0, None
    if world > 1:
        if not initialised:
            raise RuntimeError(
                f"make_sampler_mesh(world={world}) needs a process group of "
                f"{world} ranks: run under torchrun (or spawn ranks that call "
                "torch.distributed.init_process_group) first")
        if dist.get_world_size() != world:
            raise ValueError(
                f"make_sampler_mesh(world={world}) but the process group has "
                f"{dist.get_world_size()} ranks")
        rank, group = dist.get_rank(), dist.group.WORLD
    return SamplerMesh(world=world, rank=rank, device=rank_device(device),
                       group=group)


def rank_stream_seed(seed: int, rank: int, stream: int) -> int:
    """Seed of rank ``rank``'s own Philox stream at world > 1: a
    ``SeedSequence`` hash of ``(seed, stream, rank)`` cut to 63 bits.  It
    shares no arithmetic with the ``seed + i`` seeds of the candidate
    sources and the estimator, and ``stream`` (:data:`DRAW_STREAM`,
    :data:`WALK_STREAM`) keeps a sampler's draws and an estimator's walks
    apart when both start from one seed."""
    state = np.random.SeedSequence([int(seed), int(stream), int(rank)])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def partition_of_fp32(fp1: np.ndarray, world: int) -> np.ndarray:
    """Shard ownership of 32-bit row fingerprints (device-engine twin of
    :func:`repro_torch.core.distributed.partition_of`)."""
    return (np.asarray(fp1, np.uint32) % np.uint32(world)).astype(np.int64)


def row_range_bounds(nrows: int, world: int) -> np.ndarray:
    """Balanced contiguous row-range bounds ``(world + 1,)``."""
    return np.linspace(0, nrows, world + 1).astype(np.int64)


def owned_fingerprints(fp1: torch.Tensor, fp2: torch.Tensor, world: int,
                       rank: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Rank ``rank``'s slice of one relation's membership index.

    The fingerprints with ``fp1 % world == rank`` (:func:`partition_of_fp32`
    on int64 tensors holding uint32 values), stably sorted by ``fp1``, with
    ``fp2`` in the same order: ``(s1, s2, n_owned, kmax)``, ``kmax`` the
    largest duplicate run of this rank.  An empty slice is one ``_FP_PAD``
    slot with ``n_owned = 0``."""
    idx = torch.nonzero(fp1 % world == rank).flatten()
    s1, order = torch.sort(fp1[idx], stable=True)
    s2 = fp2[idx][order].contiguous()
    n = int(s1.shape[0])
    if n == 0:
        return (torch.full((1,), _FP_PAD, dtype=torch.int64,
                           device=fp1.device),
                torch.zeros(1, dtype=torch.int64, device=fp1.device), 0, 0)
    kmax = int(torch.unique_consecutive(s1, return_counts=True)[1].max())
    return s1, s2, n, kmax


# ---------------------------------------------------------------------------
# Per-join candidate generation (replicated roots)
# ---------------------------------------------------------------------------


class ShardedTreeJoin:
    """One join's candidate-generation state on this rank.

    The root draw state (weight prefix and payload columns) is
    *replicated*: every rank draws i.i.d. from the **whole** join on its own
    stream, so each rank's accepted stream is uniform over the full cover
    piece and any fixed-shape consumption order (prefix take, surplus
    banking) stays exactly uniform — the paper's independence guarantee
    makes the rank streams exchangeable.

    Why not partition the root rows?  A root-range shard draws candidates
    uniform over its *local* piece ``J_s`` only; with fixed per-rank batch
    shapes, every downstream consumption rule (take the first ``need``
    accepted, bank the rest) then over-represents whichever ranks are
    consumed first, and correcting that exactly needs per-``(cover piece,
    rank)`` sizes no estimator provides.  Replicating the root is the
    broadcast side of a distributed join; the state that dominates memory
    at scale — the membership fingerprint indexes — *is* partitioned
    (:class:`ShardedMembership`), and relation stores row-range shard via
    :meth:`ShardedCatalog.columns_for`.  ``store_bounds`` records the root
    store's row-range ownership."""

    def __init__(self, tree: TorchTreeJoin, mesh: SamplerMesh):
        self.tree = tree
        self.name = tree.name
        self.attrs = tree.attrs
        self.mode = "replicated"
        self.store_bounds = row_range_bounds(tree.n_root, mesh.world)
        self.root_prefix = tree.root_wprefix
        self.root_cols = tree.root_cols
        self.n_root = tree.n_root

    def is_empty(self) -> bool:
        return self.tree.is_empty()


# ---------------------------------------------------------------------------
# Per-join hash-partitioned membership
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _ShardedRelIndex:
    attrs: Tuple[str, ...]
    fp1: torch.Tensor       # (max(n_owned, 1),) int64 uint32 values, sorted
    fp2: torch.Tensor       # fp1 order
    n_owned: int
    kmax: int               # global duplicate window (>= any rank's)
    nrows: int


class ShardedMembership:
    """'Is tuple t in join J' with fingerprint hash-partition ownership.

    Mirrors :class:`~repro_torch.core.backends.torch_backend.
    TorchJoinMembership` (same 32-bit fingerprint arithmetic, same sorted
    index and ``kmax`` duplicate window) but this rank builds only the
    fingerprints it owns under :func:`partition_of_fp32`, so a probe must be
    routed to its owner.  ``kmax`` is global: one ``all_reduce(MAX)`` over
    the ranks at build.  With ``world == 1`` the owned index equals the
    unsharded one exactly."""

    def __init__(self, spec: JoinSpec, mesh: SamplerMesh):
        self.join_name = spec.name
        dev = mesh.device
        self.rels: List[_ShardedRelIndex] = []
        seen = set()
        for node in spec.nodes:
            rel = node.relation
            attrs = tuple(sorted(rel.attrs))
            if (rel.name, attrs) in seen:
                continue
            seen.add((rel.name, attrs))
            cols = [torch.as_tensor(_as_i32(rel.columns[a], f"{rel.name}.{a}"),
                                    device=dev) for a in attrs]
            s1, s2, n, kmax = owned_fingerprints(
                fp32(cols, salt=1), fp32(cols, salt=2), mesh.world, mesh.rank)
            self.rels.append(_ShardedRelIndex(attrs, s1, s2, n, kmax,
                                              int(rel.nrows)))
        if mesh.group is not None and self.rels:
            import torch.distributed as dist
            k = torch.tensor([r.kmax for r in self.rels], dtype=torch.int64,
                             device=dev)
            dist.all_reduce(k, op=dist.ReduceOp.MAX, group=mesh.group)
            for r, km in zip(self.rels, k.tolist()):
                r.kmax = int(km)


# ---------------------------------------------------------------------------
# The catalog
# ---------------------------------------------------------------------------


class ShardedCatalog:
    """This rank's part of one union of joins on the mesh.

    Wraps (or builds, on ``mesh.device``) a
    :class:`~repro_torch.core.backends.torch_backend.TorchBackend` — its
    :class:`TorchTreeJoin` draw state is the replicated part — and adds the
    per-rank partitions: hash-partitioned membership per join and row-range
    stores (:meth:`columns_for`).  ``mesh=None`` builds
    :func:`make_sampler_mesh` on ``device`` (``None`` is the card)."""

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec],
                 mesh: Optional[SamplerMesh] = None,
                 backend: Optional[TorchBackend] = None, seed: int = 0,
                 device=None):
        self.cat = cat
        self.joins = list(joins)
        self.mesh = mesh if mesh is not None else make_sampler_mesh(
            device=device)
        self.world = self.mesh.world
        self.device = self.mesh.device
        self.backend = backend if backend is not None else TorchBackend(
            cat, self.joins, device=self.device, seed=seed)
        self.attrs = list(self.backend.attrs)
        self.trees: Dict[str, ShardedTreeJoin] = {
            j.name: ShardedTreeJoin(self.backend.trees[j.name], self.mesh)
            for j in self.joins}
        self.members: Dict[str, ShardedMembership] = {
            j.name: ShardedMembership(j, self.mesh) for j in self.joins}
        self._col_cache: Dict[str, Dict[str, torch.Tensor]] = {}

    def shard_bounds(self, rel: Relation) -> np.ndarray:
        """Row-range ownership of one relation's store: ``(world + 1,)``."""
        return row_range_bounds(rel.nrows, self.world)

    def columns_for(self, rel: Relation) -> Dict[str, torch.Tensor]:
        """This rank's row range of the relation's columnar store, as int64
        tensors on the rank's device."""
        if rel.name not in self._col_cache:
            b = self.shard_bounds(rel)
            lo, hi = int(b[self.mesh.rank]), int(b[self.mesh.rank + 1])
            self._col_cache[rel.name] = {
                a: torch.as_tensor(np.asarray(c[lo:hi], np.int64),
                                   device=self.device)
                for a, c in rel.columns.items()}
        return self._col_cache[rel.name]
