"""Batched random sampling over a single join (the paper's §3.2 subroutine).

Port copy of ``repro.core.join_sampler``: the host engine's draws and the
build state of the device engine.  The three weight instantiations of Zhao
et al. [38] that the paper adopts, as batched numpy algebra:

* ``ew``  — Exact Weight.  ``w(t)`` = number of join tuples ``t`` yields,
  computed bottom-up over the join tree with prefix-sum semi-join
  aggregation; the root is drawn proportional to ``w`` and each child
  proportional to ``w`` within its matching range.  Zero rejection on
  acyclic joins.
* ``eo``  — Extended Olken.  Uniform root, uniform child among matches,
  accept with probability ``prod(d_edge / M_edge)``, after a backward
  semi-join pass that drops tuples which cannot reach a full join tuple
  (``reduce="backward"``; ``reduce="full"`` adds the forward pass).
* ``wj``  — Wander Join.  Like ``eo`` but never rejects; returns each tuple
  with its exact walk probability ``p(t)`` for Horvitz–Thompson estimation
  (§6.1) and for the reuse phase of ONLINE-UNION (§7).

Cyclic joins (skeleton + residual, §8.2): after the tree walk, each residual
relation contributes an acceptance factor ``d/M`` and a uniform pick among
its ``d`` matches.  The device engine
(:class:`repro_torch.core.backends.torch_backend.TorchTreeJoin`) reads the
``ew`` build state (edge indexes, max degrees, weights) and draws on the
card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .index import Catalog, SortedIndex, query_keys
from .joins import JoinNode, JoinSpec
from .relation import Relation

Rows = Dict[str, np.ndarray]


class EmptyJoinError(RuntimeError):
    """Raised when asked for uniform samples from a structurally empty join."""


@dataclasses.dataclass
class EdgePlan:
    node: JoinNode
    index: SortedIndex
    max_degree: int
    # EW only: prefix sums of child weights in sorted order, shape (n+1,)
    weight_prefix: Optional[np.ndarray] = None


@dataclasses.dataclass
class SampleBatch:
    """One round of B candidate samples."""

    rows: Rows                    # gathered output attrs, each (B,)
    ok: np.ndarray                # walk completed (no dead end)
    accept: np.ndarray            # ok AND passed accept/reject (uniform samples)
    prob: np.ndarray              # exact walk probability p(t) (wj; ew/eo: sampling prob)
    draws: int                    # candidate count (cost accounting, §3.3)

    def accepted_rows(self) -> Rows:
        idx = np.nonzero(self.accept)[0]
        return {a: c[idx] for a, c in self.rows.items()}


class JoinSampler:
    """Uniform (ew/eo) or HT-weighted (wj) batched sampler over one join."""

    def __init__(self, cat: Catalog, spec: JoinSpec, method: str = "ew",
                 reduce: str | None = None):
        if method not in ("ew", "eo", "wj"):
            raise ValueError(f"unknown method {method!r}")
        self.cat = cat
        self.spec = spec
        self.method = method
        self.reduce = reduce if reduce is not None else ("backward" if method == "eo" else "none")
        # cumulative §8.2 residual rejections (ew on cyclic joins only —
        # under eo the d/M test blends tree and residual factors)
        self.residual_rejects = 0
        self._prepare()

    # ------------------------------------------------------------------ prep
    def _prepare(self) -> None:
        spec = self.spec
        self.order: List[JoinNode] = spec.expansion_order()
        self.root = self.order[0]
        self._reduced: Dict[str, Relation] = {n.alias: n.relation for n in self.order}
        if self.reduce in ("backward", "full"):
            self._semijoin_reduce(full=self.reduce == "full")

        # Edge plans for all non-root nodes (tree children + residuals).
        self.edges: Dict[str, EdgePlan] = {}
        for n in self.order[1:]:
            rel = self._reduced[n.alias]
            idx = self.cat.index(rel, list(n.edge_attrs))
            self.edges[n.alias] = EdgePlan(n, idx, idx.max_degree())

        root_rel = self._reduced[self.root.alias]
        self.root_rel = root_rel
        self.n_root = root_rel.nrows

        if self.method == "ew":
            self._compute_exact_weights()
        else:
            self.root_weight_total = float(self.n_root)

    def _semijoin_reduce(self, full: bool) -> None:
        """Yannakakis semi-join reduction over the *tree* part.

        backward: leaf→root 'has a match' filtering (the paper's zero-weight
        fix generalised); full: adds the root→leaf pass.
        Residual relations are left untouched (they only gate acceptance).
        """
        spec = self.spec
        kids = spec.children_map()
        # backward (children filter parents)
        for n in reversed([m for m in self.order if m.kind == "tree"]):
            rel = self._reduced[n.alias]
            mask = np.ones(rel.nrows, dtype=bool)
            for c in kids.get(n.alias, []):
                crel = self._reduced[c.alias]
                cidx = self.cat.index(crel, list(c.edge_attrs))
                mask &= cidx.contains(query_keys(
                    cidx, [rel.columns[a] for a in c.edge_attrs]))
            if not mask.all():
                self._reduced[n.alias] = rel.filter(mask, name=f"{rel.name}#red{n.alias}")
        if full:
            # forward (parents filter children)
            for n in [m for m in self.order[1:] if m.kind == "tree"]:
                prel = self._reduced[n.parent]
                crel = self._reduced[n.alias]
                pidx = self.cat.index(prel, list(n.edge_attrs))
                mask = pidx.contains(query_keys(
                    pidx, [crel.columns[a] for a in n.edge_attrs]))
                if not mask.all():
                    self._reduced[n.alias] = crel.filter(mask, name=f"{crel.name}#redf{n.alias}")
            # rebuild edge indexes against reduced children happens in _prepare caller

    def _compute_exact_weights(self) -> None:
        spec = self.spec
        kids = spec.children_map()
        weights: Dict[str, np.ndarray] = {}
        for n in reversed([m for m in self.order if m.kind == "tree"]):
            rel = self._reduced[n.alias]
            w = np.ones(rel.nrows, dtype=np.float64)
            for c in kids.get(n.alias, []):
                plan = self.edges[c.alias]
                cw = weights[c.alias]
                cs = np.zeros(plan.index.nrows + 1, dtype=np.float64)
                np.cumsum(cw[plan.index.perm], out=cs[1:])
                plan.weight_prefix = cs
                lo, hi = plan.index.ranges(query_keys(
                    plan.index, [rel.columns[a] for a in c.edge_attrs]))
                w = w * (cs[hi] - cs[lo])
            weights[n.alias] = w
        self.node_weights = weights
        w_root = weights[self.root.alias]
        self.root_weight_prefix = np.zeros(self.n_root + 1, dtype=np.float64)
        np.cumsum(w_root, out=self.root_weight_prefix[1:])
        self.root_weight_total = float(self.root_weight_prefix[-1])

    # ----------------------------------------------------------------- bounds
    def size_upper_bound(self) -> float:
        """Extended-Olken style bound |J| <= |R_root| * prod M (§3.2)."""
        b = float(self.n_root)
        for plan in self.edges.values():
            b *= max(plan.max_degree, 0)
        return b

    def exact_acyclic_size(self) -> float:
        """For acyclic joins with method=ew this is the exact |J| (Σ w_root)."""
        if self.method != "ew":
            raise ValueError("exact size requires method='ew'")
        if self.spec.is_cyclic:
            raise ValueError("exact_acyclic_size on a cyclic join")
        return self.root_weight_total

    # ---------------------------------------------------------------- sampling
    def sample_batch(self, rng: np.random.Generator, batch: int) -> SampleBatch:
        """Draw ``batch`` candidates (one vectorised walk per candidate)."""
        B = int(batch)
        if self.n_root == 0 or any(p.index.nrows == 0 for p in self.edges.values()):
            return self._empty_batch(B)
        ok = np.ones(B, dtype=bool)
        prob = np.ones(B, dtype=np.float64)
        accept_ratio = np.ones(B, dtype=np.float64)

        # root draw
        if self.method == "ew":
            if self.root_weight_total <= 0:
                return self._empty_batch(B)
            u = rng.random(B)
            tgt = u * self.root_weight_total
            root_ids = np.searchsorted(self.root_weight_prefix, tgt, side="right") - 1
            root_ids = np.clip(root_ids, 0, self.n_root - 1)
            w_root = self.node_weights[self.root.alias]
            prob *= w_root[root_ids] / self.root_weight_total
        else:
            if self.n_root == 0:
                return self._empty_batch(B)
            root_ids = rng.integers(0, self.n_root, size=B)
            prob *= 1.0 / self.n_root

        rows: Rows = {a: c[root_ids] for a, c in self.root_rel.columns.items()}

        for n in self.order[1:]:
            plan = self.edges[n.alias]
            lo, hi = plan.index.ranges(query_keys(
                plan.index, [rows[a] for a in n.edge_attrs]))
            d = hi - lo
            if n.kind == "tree" and self.method == "ew":
                cs = plan.weight_prefix
                tot = cs[hi] - cs[lo]
                alive = ok & (tot > 0)
                u = rng.random(B)
                tgt = cs[lo] + u * np.maximum(tot, 1e-300)
                pos = np.searchsorted(cs, tgt, side="right") - 1
                pos = np.clip(pos, lo, np.maximum(hi - 1, lo))
                pos = np.clip(pos, 0, plan.index.nrows - 1)  # dead walks: safe gather
                cw = self.node_weights[n.alias]
                child_rows = plan.index.perm[pos]
                sel_w = cw[child_rows]
                prob = np.where(alive, prob * np.where(tot > 0, sel_w / np.maximum(tot, 1e-300), 0.0), 0.0)
                ok = alive
            else:
                alive = ok & (d > 0)
                u = rng.random(B)
                off = np.floor(u * np.maximum(d, 1)).astype(np.int64)
                pos = lo + np.minimum(off, np.maximum(d - 1, 0))
                pos = np.clip(pos, 0, plan.index.nrows - 1)  # dead walks: safe gather
                child_rows = plan.index.perm[pos]
                prob = np.where(alive, prob / np.maximum(d, 1), 0.0)
                ok = alive
                if self.method in ("eo", "ew") and (n.kind == "residual" or self.method == "eo"):
                    m = max(plan.max_degree, 1)
                    accept_ratio = np.where(alive, accept_ratio * d / m, 0.0)
            rel = self._reduced[n.alias]
            safe_rows = np.where(ok, child_rows, 0)
            for a in rel.attrs:
                if a not in rows:
                    rows[a] = rel.columns[a][safe_rows]

        if self.method == "wj":
            accept = ok.copy()
        else:
            u = rng.random(B)
            accept = ok & (u < accept_ratio)
            if self.method == "ew" and self.spec.is_cyclic:
                self.residual_rejects += int((ok & ~accept).sum())
        return SampleBatch(rows=rows, ok=ok, accept=accept, prob=np.where(ok, prob, 0.0), draws=B)

    def _empty_batch(self, B: int) -> SampleBatch:
        rows = {a: np.zeros(B, dtype=np.int64) for a in self.spec.output_attrs}
        z = np.zeros(B, dtype=bool)
        return SampleBatch(rows=rows, ok=z, accept=z.copy(), prob=np.zeros(B), draws=B)

    def sample_uniform(self, rng: np.random.Generator, n: int,
                       batch: int = 1024, max_rounds: int = 10_000
                       ) -> Tuple[Rows, int]:
        """Collect ``n`` uniform samples (ew/eo); returns (rows, total draws)."""
        if self.method == "wj":
            raise ValueError("wj samples are not uniform; use sample_batch + HT")
        if self.is_empty():
            raise EmptyJoinError(f"join {self.spec.name!r} is empty")
        got: List[Rows] = []
        total = 0
        count = 0
        for _ in range(max_rounds):
            sb = self.sample_batch(rng, batch)
            total += sb.draws
            acc = sb.accepted_rows()
            k = next(iter(acc.values())).shape[0] if acc else 0
            if k:
                got.append(acc)
                count += k
            if count >= n:
                break
        else:
            raise RuntimeError(f"sample_uniform: exceeded {max_rounds} rounds")
        rows = {a: np.concatenate([g[a] for g in got])[:n] for a in got[0]}
        return rows, total

    def is_empty(self) -> bool:
        if self.n_root == 0 or any(p.index.nrows == 0 for p in self.edges.values()):
            return True
        if self.method == "ew" and self.root_weight_total <= 0:
            return True
        return False

    # ------------------------------------------------------------- acceptance
    def acceptance_rate(self, rng: np.random.Generator, probe: int = 4096) -> float:
        sb = self.sample_batch(rng, probe)
        return float(sb.accept.mean())
