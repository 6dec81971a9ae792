"""Exact-Weight preparation of one join (the paper's §3.2 subroutine).

Port copy of the build-time half of ``repro.core.join_sampler.JoinSampler``
for ``method="ew"`` (the only method the device engine runs): expansion
order, the per-node sorted edge indexes with their max degrees, and the
Exact Weights ``w(t)`` computed bottom-up with prefix-sum semi-join
aggregation.  ``w(t)`` = number of join tuples ``t`` yields over the acyclic
skeleton; drawing the root proportional to ``w`` and each child proportional
to ``w`` within its matching range is uniform with zero rejection on acyclic
joins.  Residual (§8.2) nodes keep only their index and max degree ``M``:
the draw accepts with ``Π d/M``.

The draws themselves run on the device
(:class:`repro_torch.core.backends.torch_backend.TorchTreeJoin`); this
class is used at build time only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .index import Catalog, SortedIndex
from .joins import JoinNode, JoinSpec
from .relation import Relation, combine_columns


class EmptyJoinError(RuntimeError):
    """Raised when asked for uniform samples from a structurally empty join."""


@dataclasses.dataclass
class EdgePlan:
    node: JoinNode
    index: SortedIndex
    max_degree: int
    # prefix sums of child weights in sorted order, shape (n+1,)
    weight_prefix: Optional[np.ndarray] = None


class JoinSampler:
    """Exact-Weight (EW) build state of one join."""

    def __init__(self, cat: Catalog, spec: JoinSpec):
        self.cat = cat
        self.spec = spec
        self.order: List[JoinNode] = spec.expansion_order()
        self.root = self.order[0]
        # ew never semi-join reduces: the reduced relations are the originals
        self._reduced: Dict[str, Relation] = {n.alias: n.relation for n in self.order}
        self.edges: Dict[str, EdgePlan] = {}
        for n in self.order[1:]:
            idx = cat.index(n.relation, list(n.edge_attrs))
            self.edges[n.alias] = EdgePlan(n, idx, idx.max_degree())
        self.root_rel = self.root.relation
        self.n_root = self.root_rel.nrows
        self._compute_exact_weights()

    def _compute_exact_weights(self) -> None:
        kids = self.spec.children_map()
        weights: Dict[str, np.ndarray] = {}
        for n in reversed([m for m in self.order if m.kind == "tree"]):
            rel = self._reduced[n.alias]
            w = np.ones(rel.nrows, dtype=np.float64)
            for c in kids.get(n.alias, []):
                plan = self.edges[c.alias]
                cs = np.zeros(plan.index.nrows + 1, dtype=np.float64)
                np.cumsum(weights[c.alias][plan.index.perm], out=cs[1:])
                plan.weight_prefix = cs
                key = combine_columns([rel.columns[a] for a in c.edge_attrs])
                lo, hi = plan.index.ranges(key)
                w = w * (cs[hi] - cs[lo])
            weights[n.alias] = w
        self.node_weights = weights
        self.root_weight_prefix = np.zeros(self.n_root + 1, dtype=np.float64)
        np.cumsum(weights[self.root.alias], out=self.root_weight_prefix[1:])
        self.root_weight_total = float(self.root_weight_prefix[-1])

    def size_upper_bound(self) -> float:
        """Extended-Olken style bound |J| <= |R_root| * prod M (§3.2)."""
        b = float(self.n_root)
        for plan in self.edges.values():
            b *= max(plan.max_degree, 0)
        return b

    def exact_acyclic_size(self) -> float:
        """For acyclic joins this is the exact |J| (Σ w_root)."""
        if self.spec.is_cyclic:
            raise ValueError("exact_acyclic_size on a cyclic join")
        return self.root_weight_total

    def is_empty(self) -> bool:
        if self.n_root == 0 or any(p.index.nrows == 0 for p in self.edges.values()):
            return True
        return self.root_weight_total <= 0
