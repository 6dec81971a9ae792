"""Mesh-sharded Algorithm-1 rounds on ``torch.distributed``.

Port of ``repro.core.sharding.sampler``.  :class:`ShardedUnionSampler`
runs Algorithm-1 rounds that span every rank of the mesh, in either of the
unsharded engine's loops
(:class:`~repro_torch.core.backends.torch_backend.TorchUnionSampler`).
One round, on each rank:

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
6. **local compaction** of the accepted rows.

Then the two loops part:

* ``fused_rounds="device"`` (the default, the reference's per-shard device
  loop): each rank keeps its own FIFO banks of ``surplus_cap // world``
  rows per piece; only the small carry (shortfall, dead flags, streaks,
  under ``plan="adaptive"`` the EMAs and the global bank occupancy) is
  replicated.  One ``all_gather_into_tensor`` of every rank's ``(7, nj)``
  stack of bank count, accepted, ok, residual, predicate-reject,
  residual-miss and member-lookup counts lets every rank compute the same
  shard-major water filling (bank take, then fresh take, rank ``s``'s
  slice of each) and its own rows' global output positions, with no further collective; each rank
  scatters its rows there in an output of its own, and one
  ``all_reduce(SUM)`` merges the disjoint outputs at the fetch.  The round
  is the unsharded engine's gated step over static buffers: at world 1 (no
  collective) it is captured as one CUDA graph per capacity class on the
  card and replayed in chunks; at world > 1 it runs eagerly in chunks of
  ``K`` rounds, ``K`` taken from the replicated ``total`` and ``rounds``
  only, so every rank issues the same collectives; one host sync per chunk
  either way.
* ``fused_rounds="host"``: **one all-gather** of the accepted matrices and
  counts per round, so every rank holds the same global shard-major
  matrices, and the inherited host loop (global surplus banking, one sync
  per round) runs the same on every rank.

Either way every rank's ``sample(n)`` returns the same global
``SampleSet``.

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
unbiased.  At world 1 both loops equal the unsharded engine bit for bit; at
world > 1 they differ once banks fill (per-rank FIFO banks against one
global bank), both unbiased, as in the reference.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import planner
from ..backends.torch_backend import (PhiloxUniforms, TorchUnionSampler,
                                      _CallBuffers, _cover_cum,
                                      _emit_and_bank, _LoopState,
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

    ``fused_rounds`` picks the loop (module docstring): ``"device"`` (the
    reference's default) with per-rank banks, ``"host"`` with a global bank.
    ``round_batch`` is the *per-rank* selection-slot budget; per-join draw
    widths are cover-balanced per rank (``shard_piece_batches``), and the
    global schedule (``piece_batches``, read by the stats accounting and
    the banks) is ``world`` times that.  ``uniforms`` replaces the shared
    stream (tests replay the reference's keys through it at world 1)."""

    def __init__(self, scat: ShardedCatalog, cover, seed: int = 0,
                 round_batch: int = 4096, dead_rounds: int = 8,
                 max_rounds: int = 4096, surplus_cap: Optional[int] = None,
                 stats=None, fused_rounds: str = "device",
                 balance: str = "cover", balance_slack: float = 1.5,
                 uniforms=None, predicate=None, plan: str = "static"):
        self.scat = scat
        self.mesh = scat.mesh
        self.world, self.rank = scat.world, scat.mesh.rank
        self.shard_batch = int(round_batch)
        super().__init__(scat.backend, cover, seed=seed,
                         round_batch=self.shard_batch * self.world,
                         dead_rounds=dead_rounds, max_rounds=max_rounds,
                         surplus_cap=surplus_cap, stats=stats,
                         fused_rounds=fused_rounds, balance=balance,
                         balance_slack=balance_slack, uniforms=uniforms,
                         predicate=predicate, plan=plan)
        # per-rank cover-balanced widths (demand-matched at rank granularity
        # under the adaptive plan); at world 1 they are the unsharded ones
        base = np.maximum(np.asarray(cover.selection_probs(), np.float64), 0)
        bs = _piece_batches(base, self.shard_batch, balance, balance_slack)
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
        """The host loop's round: this rank's round, then one all-gather of
        the compacted matrices and counts (world > 1)."""
        mats, counts, need, budget = self._local_round(
            probs_cum, owed, extra, ema, bank_count)
        if self.world > 1:
            mats, counts = self._gather_round(mats, counts)
        return (mats, counts[0], counts[1], counts[2], counts[3], need,
                budget, counts[4].sum(), counts[5].sum())

    def _local_round(self, probs_cum, owed, extra, ema=None,
                     bank_count=None):
        """Selection, this rank's draws, predicates, the fingerprint
        exchange and compaction.  Returns this rank's compacted
        ``(B_j, A+1)`` matrices, its ``(6, nj)`` (walk_ok, residual,
        accepted, predicate-reject, residual-miss, member-lookup) counts
        (lookups: live candidates times earlier pieces), the replicated
        per-piece need and (adaptive plan, else None) the replicated global
        budget;
        ``bank_count`` is the global bank occupancy the budget reads."""
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
        rows_j, acc_j, okc, resc, predc, missc = [], [], [], [], [], []
        for j, st in enumerate(self.strees):
            rows, acc, walk_ok, *skel = st.tree.draw_with_root(
                u_joins[j], st.root_prefix, st.root_cols, st.n_root,
                skeleton=st.tree.has_residual)
            if bshard is not None:
                elig = torch.arange(bs[j], device=dev) < bshard[j]
                acc = acc & elig
                walk_ok = walk_ok & elig
                skel = [s & elig for s in skel]
            resc.append(walk_ok.sum() - acc.sum())
            missc.append(skel[0].sum() - walk_ok.sum() if skel
                         else self._zero)
            okc.append(walk_ok.sum())
            acc, pr = self._pred_mask(j, rows, acc)
            predc.append(pr)
            rows_j.append(rows)
            acc_j.append(acc)
        # (4) one fingerprint exchange answers every earlier-piece probe
        found = self._exchange_probes(rows_j)
        # (5) containment, (6) local compaction (home id as last column)
        mats, accc, lookc = [], [], []
        p = 0
        for j in range(nj):
            acc = acc_j[j]
            lookc.append(acc.sum() * j)
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
                              torch.stack(accc), torch.stack(predc),
                              torch.stack(missc), torch.stack(lookc)])
        return mats, counts, need, budget

    # -- the per-rank device loop (fused_rounds="device") ----------------------
    def _bank_cap(self) -> int:
        # device mode: the reference's per-shard banks of surplus_cap // world
        if self.fused_rounds == "device":
            return max(1, self.surplus_cap // self.world)
        return self.surplus_cap

    def _init_state(self) -> _LoopState:
        st = super()._init_state()
        if self.plan == "adaptive":
            st.gcount = torch.zeros_like(st.count)
        return st

    def _round_step(self, cb: _CallBuffers) -> None:
        if self.fused_rounds == "host":
            return super()._round_step(cb)
        return self._shard_step(cb)

    def _gather_counts(self, local: torch.Tensor) -> torch.Tensor:
        """Every rank's ``(7, nj)`` count stack as ``(world, 7, nj)``."""
        if self.world == 1:
            return local[None]
        import torch.distributed as dist
        g = torch.empty(self.world * local.numel(), dtype=local.dtype,
                        device=local.device)
        dist.all_gather_into_tensor(g, local.reshape(-1),
                                    group=self.mesh.group)
        return g.view(self.world, *local.shape)

    def _shard_step(self, cb: _CallBuffers) -> None:
        """One round of the per-rank device loop on the static buffers.

        The unsharded engine's gated step (``TorchUnionSampler._round_step``:
        every write gated by the replicated ``active``) with the
        reference's shard-major water filling
        (``repro.core.sharding.sampler._build_loop``): from the gathered
        counts every rank computes the same global bank and fresh takes,
        its own slice of each, and the global positions of its rows."""
        st = self._state
        cap = self._bank_cap()
        adaptive = self.plan == "adaptive"
        zero = self._zero
        r = self.rank
        active = ((cb.total < cb.n) & (cb.rounds < self.max_rounds)
                  & (cb.fail == 0))
        probs_cum, bad = _cover_cum(self._probs_base, st.dead)
        extra = torch.where(active, torch.clamp(
            cb.n - cb.total - st.owed.sum(), 0, self._slot_width), zero)
        mats, counts, need, budget = self._local_round(
            probs_cum, st.owed, extra, st.ema, st.gcount)
        need = torch.where(active, need, zero)
        okc, resc, accc, predc, missc, lookc = counts
        # one tiny exchange: (bank count, accepted, ok, residual,
        # predicate-reject, residual-miss, member-lookup) of every rank
        gat = self._gather_counts(torch.stack(
            [st.count, accc, okc, resc, predc, missc, lookc]).to(torch.int64))
        counts_w = gat[:, 0]                                # (world, nj)
        acc_w = torch.where(active, gat[:, 1], zero)
        acc_v, ok_v, res_v, pred_v, miss_v, look_v = (gat[:, i].sum(0)
                                                      for i in range(1, 7))
        accg = acc_w.sum(0)
        # bank take (FIFO, capped) → fresh take → carried shortfall
        dtg = torch.clamp(torch.minimum(need, counts_w.sum(0)),
                          max=self._drain_w)
        ftg = torch.minimum(need - dtg, accg)
        # shard-major water filling: rank s serves the slice of the global
        # take that lands in its segment of the prefix sums
        dt_w = torch.minimum(torch.clamp(
            dtg[None] - (torch.cumsum(counts_w, 0) - counts_w), min=0),
            counts_w)
        ft_w = torch.minimum(torch.clamp(
            ftg[None] - (torch.cumsum(acc_w, 0) - acc_w), min=0), acc_w)
        takeg = dtg + ftg
        seg = cb.total + torch.cumsum(takeg, 0) - takeg
        bank_base = seg + (torch.cumsum(dt_w, 0) - dt_w)[r]
        fresh_base = seg + dtg + (torch.cumsum(ft_w, 0) - ft_w)[r]
        _, head, count = _emit_and_bank(
            cb.out, cb.total, st.bank, st.head, st.count, mats, dt_w[r],
            ft_w[r], acc_w[r], cap, cb.C, min(self._drain_w, cap),
            bank_base=bank_base, fresh_base=fresh_base)
        # global post-round bank occupancy for the dead-piece rules
        push_w = torch.minimum(acc_w - ft_w, cap - (counts_w - dt_w))
        countg = (counts_w - dt_w + push_w).sum(0)
        shortfall = need - dtg - ftg
        dropped = torch.where(st.dead, shortfall, zero).sum()
        shortfall = torch.where(st.dead, zero, shortfall)
        trig = (shortfall > 0) & (accg == 0) & (countg == 0)
        streak = torch.where(st.dead, st.streak,
                             torch.where(trig, st.streak + 1, zero))
        newly = ~st.dead & (streak >= self.dead_rounds) & active
        dropped = dropped + torch.where(newly, shortfall, zero).sum()
        shortfall = torch.where(newly, zero, shortfall)
        drawn = (budget.sum() if adaptive
                 else zero + int(sum(self.piece_batches)))
        cb.stats.add_(torch.where(active, torch.stack([
            drawn, drawn, ok_v.sum() - res_v.sum() - pred_v.sum()
            - acc_v.sum(), res_v.sum(), pred_v.sum(), dropped,
            miss_v.sum(), look_v.sum()]), zero))
        ps = cb.pstats
        cb.pstats.copy_(torch.where(active, torch.stack([
            ps[:, 0] + (budget if adaptive else self._pbatch),
            ps[:, 1] + acc_v, ps[:, 2] + res_v, ps[:, 3] + dtg,
            torch.maximum(ps[:, 4], countg)], dim=1), ps))
        if adaptive:
            # the EMA step from the gathered global counts (no collective);
            # the post-round global occupancy is next round's budget input
            counts4 = torch.stack([acc_v, ok_v, res_v, pred_v],
                                  dim=1).to(torch.int32)
            st.ema.copy_(torch.where(active, planner.ema_update(
                st.ema, budget, counts4, self._ema_shifts, planner.TORCH_XP),
                st.ema))
            st.gcount.copy_(countg)
        st.owed.copy_(torch.where(active, shortfall, st.owed))
        st.dead.logical_or_(newly)
        st.streak.copy_(torch.where(active, streak, st.streak))
        st.head.copy_(head)
        st.count.copy_(count)
        cb.total.add_(takeg.sum())
        cb.fail.logical_or_(bad & active)
        cb.rounds.add_(active.to(torch.int64))

    def _graphs(self) -> bool:
        # world > 1: the step's collectives are not captured (NCCL capture
        # is untried); the step runs eagerly in chunks
        return super()._graphs() and self.world == 1

    def _defers_finish(self) -> bool:
        # world > 1: the step runs eagerly and the pack all-reduces, so the
        # call is finished inside sample_async
        return super()._defers_finish() and self.world == 1

    def _reset(self, cb: _CallBuffers, n: int) -> None:
        super()._reset(cb, n)
        if self.fused_rounds == "device" and self.world > 1:
            cb.out.zero_()          # the ranks' outputs merge by summation

    def _call_rows(self, cb: _CallBuffers, n: int) -> torch.Tensor:
        if self.fused_rounds == "host" or self.world == 1:
            return cb.out[:n]
        import torch.distributed as dist
        rows = cb.out[:n].clone()
        dist.all_reduce(rows, op=dist.ReduceOp.SUM, group=self.mesh.group)
        return rows

    def _round_shapes(self) -> List[Tuple[int, int]]:
        return [(t.n_streams, b)
                for t, b in zip(self.trees, self.shard_piece_batches)]

    def _mark_uniforms(self):
        if self.world == 1:
            return self.uniforms.mark()
        return self.uniforms.mark(), self.shard_uniforms.mark()

    def _rewind_uniforms(self, mark, rounds: int) -> None:
        if self.world == 1:
            return super()._rewind_uniforms(mark, rounds)
        # a round draws the selection slots from the shared stream and the
        # candidates from this rank's own
        self.uniforms.rewind(mark[0], rounds, self._slot_width, [])
        self.shard_uniforms.rewind(mark[1], rounds, 0, self._round_shapes())

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

        def fp_of(j: int, attrs: Tuple[str, ...]):
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
        and its ``(6, nj)`` counts; returns the global shard-major matrices
        (rank ``s``'s accepted rows after those of ranks ``< s``) and the
        summed counts, the same on every rank."""
        import torch.distributed as dist
        world, dev = self.world, self.device
        flat = torch.cat([m.reshape(-1) for m in mats]
                         + [counts.to(torch.int32).reshape(-1)])
        g = torch.empty(world * flat.shape[0], dtype=torch.int32, device=dev)
        dist.all_gather_into_tensor(g, flat, group=self.mesh.group)
        g = g.view(world, flat.shape[0])
        nj, nc = len(mats), counts.shape[0]
        every = g[:, flat.shape[0] - nc * nj:].reshape(world, nc, nj).to(
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
