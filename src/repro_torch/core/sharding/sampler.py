"""Mesh-sharded Algorithm-1 rounds on ``torch.distributed``.

Port of ``repro.core.sharding.sampler`` (its ``fused_rounds="host"`` twin).
:class:`ShardedUnionSampler` runs the unsharded engine's host-driven loop
(:class:`~repro_torch.core.backends.torch_backend.TorchUnionSampler`) over
a round that spans every rank of the mesh.  One round, on each rank:

1. **replicated cover selection** — every rank takes the same per-slot
   picks from a stream seeded the same on every rank and histograms them
   into the global per-piece targets (no communication);
2. **local candidate draws** — each rank draws its per-join batch of
   i.i.d. EW candidates from the *whole* join
   (:class:`~repro_torch.core.sharding.catalog.ShardedTreeJoin`) on a
   stream of its own; the draws run the CUDA probe kernels, and cyclic
   joins verify their residual edges in the same draw;
3. **§8.3 predicate masks**, as in the unsharded round;
4. **one fingerprint exchange** — an ``all_gather_into_tensor`` of the
   candidates' ``(fp1, fp2)`` per probe of the plan (every earlier piece's
   every base relation, padded to the widest draw batch); each owner
   answers the fingerprints it owns against its sorted index
   (:func:`_window_probe`), and one ``reduce_scatter_tensor`` sums the
   owner verdicts and hands each rank its own candidates' segment;
5. **containment** by the earlier pieces' own ``reject_preds``
   (``_cont_pred_fns``): the exchange probes raw relation fingerprints;
6. **local compaction** of the accepted rows;
7. **one all-gather** of the accepted matrices and counts, so every rank
   holds the same global shard-major matrices.  The inherited host loop
   (selection carry, global surplus banking, dead pieces, adaptive EMAs,
   final shuffle) then runs the same on every rank, and every rank's
   ``sample(n)`` returns the same global ``SampleSet``.

``round_batch`` is per rank; the global round is ``world`` times it.

**Streams.**  At world 1 the picks and the draws come from one stream in
the unsharded round's order, and the mesh engine equals the unsharded one
bit for bit (no collective runs).  At world > 1 the picks and the output
shuffle come from the stream seeded ``seed`` (the same on every rank), and
rank ``r``'s draws from a Philox stream seeded
``rank_stream_seed(seed, r, DRAW_STREAM)``.

Exactness: every rank's candidates are i.i.d. uniform over the whole join,
so their cover-accepted subsequences are i.i.d. uniform over the piece and
exchangeable across ranks, and the shard-major consumption order is
unbiased.  The reference's per-shard device loop with per-shard FIFO banks
is not ported: the port has one (host-driven) loop, whose banking is
global.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import planner
from ..backends.torch_backend import (PhiloxUniforms, TorchUnionSampler,
                                      _piece_batches, fp32)
from ..predicates import compile_preds_torch
from .catalog import DRAW_STREAM, ShardedCatalog, rank_stream_seed


def _window_probe(s1: torch.Tensor, s2: torch.Tensor, n_own: int,
                  q1: torch.Tensor, q2: torch.Tensor, kmax: int
                  ) -> torch.Tensor:
    """Sorted-fingerprint probe with a duplicate window of ``kmax`` (one
    rank's owned index; positions at or past ``n_own`` are pads)."""
    lo = torch.searchsorted(s1, q1, side="left")
    m = torch.zeros(q1.shape, dtype=torch.bool, device=q1.device)
    cap = s1.shape[0]
    for k in range(kmax):       # duplicate window (tiny)
        pos = torch.clamp(lo + k, max=cap - 1)
        m = m | ((lo + k < n_own) & (s1[pos] == q1) & (s2[pos] == q2))
    return m


class ShardedUnionSampler(TorchUnionSampler):
    """Algorithm-1 rounds over the ranks of a :class:`SamplerMesh`.

    ``round_batch`` is the *per-rank* selection-slot budget; per-join draw
    widths are cover-balanced per rank (``shard_piece_batches``), and the
    global schedule (``piece_batches``, read by the stats accounting and
    the banks) is ``world`` times that.  ``uniforms`` replaces the shared
    stream (tests replay the reference's keys through it at world 1)."""

    def __init__(self, scat: ShardedCatalog, cover, seed: int = 0,
                 round_batch: int = 4096, surplus_cap: Optional[int] = None,
                 stats=None, uniforms=None, predicate=None,
                 plan: str = "static"):
        self.scat = scat
        self.mesh = scat.mesh
        self.world, self.rank = scat.world, scat.mesh.rank
        self.shard_batch = int(round_batch)
        super().__init__(scat.backend, cover, seed=seed,
                         round_batch=self.shard_batch * self.world,
                         stats=stats, uniforms=uniforms, predicate=predicate,
                         plan=plan, surplus_cap=surplus_cap)
        # per-rank cover-balanced widths (demand-matched at rank granularity
        # under the adaptive plan); at world 1 they are the unsharded ones
        base = np.maximum(np.asarray(cover.selection_probs(), np.float64), 0)
        bs = _piece_batches(base, self.shard_batch)
        if plan == "adaptive":
            bs = planner.alloc_batches(bs, base, self._ema_seed[:, 0],
                                       planner.adaptive_slot(self.shard_batch))
        self.shard_piece_batches = tuple(int(b) for b in bs)
        self._set_piece_batches([self.world * b
                                 for b in self.shard_piece_batches])
        self.strees = [scat.trees[n] for n in self.order]
        self.smems = [scat.members[n] for n in self.order]
        # a candidate lies in earlier piece q only if q's own reject_preds
        # hold too (the union-wide predicate is excluded: candidates already
        # passed it, so it cannot separate a tuple from piece q)
        self._cont_pred_fns = [
            compile_preds_torch(t.spec.reject_preds, t.spec.output_attrs)
            if t.spec.reject_preds else None for t in self.trees]
        # flat probe plan: (join j, earlier piece q, relation index)
        self._probe_plan: List[Tuple[int, int, int]] = [
            (j, q, r) for j in range(len(self.order)) for q in range(j)
            for r in range(len(self.smems[q].rels))]
        self.shard_uniforms = (None if self.world == 1 else PhiloxUniforms(
            rank_stream_seed(seed, self.rank, DRAW_STREAM), self.device))

    # -- one round -------------------------------------------------------------
    def _round_core(self, probs_cum, owed, extra, ema=None, bank_count=None):
        nj = len(self.trees)
        dev = self.device
        world = self.world
        bs = self.shard_piece_batches
        shapes = [(t.n_streams, b) for t, b in zip(self.trees, bs)]
        if world == 1:
            u_sel, u_joins = self.uniforms.round(self._slot_width, shapes)
        else:
            u_sel, _ = self.uniforms.round(self._slot_width, [])
            _, u_joins = self.shard_uniforms.round(0, shapes)
        # (1) replicated cover selection over all global slots
        pick = torch.clamp(torch.searchsorted(probs_cum, u_sel, side="right"),
                           0, nj - 1)
        valid = (torch.arange(self._slot_width, device=dev)
                 < extra).to(torch.int64)
        need = owed + torch.zeros(nj, dtype=torch.int64,
                                  device=dev).scatter_add_(0, pick, valid)
        budget = bshard = None
        if ema is not None:
            # the replicated global budget, split so the per-rank shares sum
            # to it exactly (world 1: the unsharded budget)
            budget = planner.budget_for(
                need.to(torch.int32), bank_count.to(torch.int32), ema[:, 0],
                self._pbatch_i32, self._drain_w, planner.TORCH_XP)
            bshard = (budget // world
                      + (self.rank < budget % world).to(torch.int32))
        # (2) local i.i.d. whole-join draws, (3) predicate masks
        rows_j, acc_j, okc, resc, predc = [], [], [], [], []
        for j, st in enumerate(self.strees):
            rows, acc, walk_ok = st.tree.draw_with_root(
                u_joins[j], st.root_prefix, st.root_cols, st.n_root)
            if bshard is not None:
                elig = torch.arange(bs[j], device=dev) < bshard[j]
                acc = acc & elig
                walk_ok = walk_ok & elig
            resc.append(walk_ok.sum() - acc.sum())
            okc.append(walk_ok.sum())
            acc, pr = self._pred_mask(j, rows, acc)
            predc.append(pr)
            rows_j.append(rows)
            acc_j.append(acc)
        # (4) one fingerprint exchange answers every earlier-piece probe
        found = self._exchange_probes(rows_j)
        # (5) containment, (6) local compaction (home id as last column)
        mats, accc = [], []
        p = 0
        for j in range(nj):
            acc = acc_j[j]
            for q in range(j):
                contained = torch.ones(bs[j], dtype=torch.bool, device=dev)
                for _ in self.smems[q].rels:
                    contained = contained & found[p]
                    p += 1
                cpf = self._cont_pred_fns[q]
                if cpf is not None:
                    contained = contained & cpf(rows_j[j])
                acc = acc & ~contained
            dst = torch.where(acc, torch.cumsum(acc, 0) - 1, bs[j])
            mat = torch.stack([rows_j[j][a] for a in self.attrs]
                              + [torch.full((bs[j],), j, dtype=torch.int32,
                                            device=dev)], dim=1)
            col = torch.zeros((bs[j] + 1, mat.shape[1]), dtype=torch.int32,
                              device=dev)
            col[dst] = mat
            mats.append(col[:bs[j]])
            accc.append(acc.sum())
        counts = torch.stack([torch.stack(okc), torch.stack(resc),
                              torch.stack(accc), torch.stack(predc)])
        if world == 1:
            cols = mats
        else:
            cols, counts = self._gather_round(mats, counts)
        return (cols, counts[0], counts[1], counts[2], counts[3], need,
                budget)

    def _exchange_probes(self, rows_j) -> List[torch.Tensor]:
        """All earlier-piece membership probes of the round, one verdict
        vector per probe of the plan.

        ``world == 1``: local probes of the whole index, bit-equal to
        :meth:`TorchJoinMembership.contains`.  Otherwise one
        ``all_gather_into_tensor`` of every probe's ``(fp1, fp2)``, padded to
        the widest draw batch; each rank answers the fingerprints it owns
        (pads never hit), and one ``reduce_scatter_tensor`` sums the owner
        verdicts and returns this rank's own segment."""
        plan = self._probe_plan
        if not plan:
            return []
        bs = self.shard_piece_batches
        fps = {}

        def fp_of(j, attrs):
            if (j, attrs) not in fps:
                cols = [rows_j[j][a] for a in attrs]
                fps[(j, attrs)] = (fp32(cols, salt=1), fp32(cols, salt=2))
            return fps[(j, attrs)]

        rels = [self.smems[q].rels[r] for (_j, q, r) in plan]
        if self.world == 1:
            return [_window_probe(rel.fp1, rel.fp2, rel.n_owned,
                                  *fp_of(j, rel.attrs), rel.kmax)
                    for (j, _q, _r), rel in zip(plan, rels)]
        import torch.distributed as dist
        world, dev, group = self.world, self.device, self.mesh.group
        n_probe = len(plan)
        bmax = max(bs[j] for (j, _q, _r) in plan)
        q = torch.zeros((2, n_probe, bmax), dtype=torch.int64, device=dev)
        width = torch.tensor([bs[j] for (j, _q, _r) in plan], device=dev)
        for pi, ((j, _q, _r), rel) in enumerate(zip(plan, rels)):
            q1, q2 = fp_of(j, rel.attrs)
            q[0, pi, :bs[j]] = q1
            q[1, pi, :bs[j]] = q2
        g = torch.empty(world * q.numel(), dtype=torch.int64, device=dev)
        dist.all_gather_into_tensor(g, q.reshape(-1), group=group)
        # (probe, rank-major global slot): rank s's candidates at s*bmax
        g = g.view(world, 2, n_probe, bmax).permute(1, 2, 0, 3).reshape(
            2, n_probe, world * bmax)
        real = (torch.arange(bmax, device=dev)[None, :]
                < width[:, None]).repeat(1, world)
        hits = torch.zeros((n_probe, world * bmax), dtype=torch.int32,
                           device=dev)
        for pi, rel in enumerate(rels):
            m = _window_probe(rel.fp1, rel.fp2, rel.n_owned, g[0, pi],
                              g[1, pi], rel.kmax)
            # only the fingerprint's owner answers (hash partition)
            hits[pi] = (m & (g[0, pi] % world == self.rank)
                        & real[pi]).to(torch.int32)
        out = torch.empty(n_probe * bmax, dtype=torch.int32, device=dev)
        dist.reduce_scatter_tensor(
            out, hits.view(n_probe, world, bmax).transpose(0, 1).reshape(-1),
            group=group)
        out = out.view(n_probe, bmax)
        return [out[pi, :bs[j]] > 0 for pi, (j, _q, _r) in enumerate(plan)]

    def _gather_round(self, mats, counts):
        """One ``all_gather_into_tensor`` of this rank's compacted matrices
        and its ``(4, nj)`` counts; returns the global shard-major matrices
        (rank ``s``'s accepted rows after those of ranks ``< s``) and the
        summed counts, the same on every rank."""
        import torch.distributed as dist
        world, dev = self.world, self.device
        flat = torch.cat([m.reshape(-1) for m in mats]
                         + [counts.to(torch.int32).reshape(-1)])
        g = torch.empty(world * flat.shape[0], dtype=torch.int32, device=dev)
        dist.all_gather_into_tensor(g, flat, group=self.mesh.group)
        g = g.view(world, flat.shape[0])
        nj = len(mats)
        every = g[:, flat.shape[0] - 4 * nj:].reshape(world, 4, nj).to(
            torch.int64)
        cols, off = [], 0
        for j, m in enumerate(mats):
            b, a1 = m.shape
            rows = g[:, off:off + b * a1].reshape(world * b, a1)
            off += b * a1
            keep = (torch.arange(b, device=dev)[None, :]
                    < every[:, 2, j][:, None]).reshape(-1)
            dst = torch.where(keep, torch.cumsum(keep, 0) - 1, world * b)
            col = torch.zeros((world * b + 1, a1), dtype=torch.int32,
                              device=dev)
            col[dst] = rows
            cols.append(col[:world * b])
        return cols, every.sum(0)
