"""Batched host membership probes: is output tuple ``t`` in join ``J``?

Port copy of ``repro.core.membership`` (the host engine's oracle).  Every
join keeps its full output schema, so a tuple belongs to a join iff each
base relation of the join contains the tuple's projection onto that
relation's attributes (the shared join attributes make the projections
connect).  The probe is one :class:`~repro_torch.core.index.RowSetIndex`
lookup per relation, AND-reduced; a join's §8.3 ``reject_preds`` define the
filtered join, so they are ANDed in first.

Tuple identity (set-union semantics) uses the 128-bit fingerprint of the
output-schema values.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .index import Catalog
from .joins import JoinSpec
from .relation import fingerprint128


class MembershipProber:
    """Caches per-relation row-set indexes for a set of joins."""

    def __init__(self, cat: Catalog, joins: Sequence[JoinSpec]):
        self.cat = cat
        self.joins = {j.name: j for j in joins}
        schemas = [tuple(sorted(j.output_attrs)) for j in joins]
        if len(set(schemas)) > 1:
            raise ValueError(
                f"joins must share an output schema; got {sorted(set(schemas))}")
        self.output_attrs: List[str] = list(joins[0].output_attrs)

    def contains(self, join_name: str, rows: Dict[str, np.ndarray]) -> np.ndarray:
        """Vector of booleans: does ``join_name`` contain each tuple of ``rows``?"""
        spec = self.joins[join_name]
        ok = np.ones(rows_length(rows), dtype=bool)
        for p in spec.reject_preds:
            ok &= p.mask(rows)
        for node in spec.nodes:
            if not ok.any():
                break
            rs = self.cat.rowset(node.relation, node.relation.attrs)
            ok &= rs.contains_rows(rows)
        return ok

    def membership_matrix(self, rows: Dict[str, np.ndarray],
                          join_names: Sequence[str] | None = None) -> np.ndarray:
        """(n_tuples, n_joins) boolean membership matrix."""
        names = list(join_names) if join_names is not None else list(self.joins)
        return np.stack([self.contains(name, rows) for name in names], axis=1)

    def fingerprints(self, rows: Dict[str, np.ndarray]) -> np.ndarray:
        """(n, 2) uint64 tuple-value fingerprints in output-schema order."""
        return fingerprint128([np.asarray(rows[a]) for a in self.output_attrs])


def rows_subset(rows: Dict[str, np.ndarray], idx: np.ndarray) -> Dict[str, np.ndarray]:
    return {a: c[idx] for a, c in rows.items()}


def rows_concat(parts: Sequence[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    keys = list(parts[0].keys())
    return {a: np.concatenate([p[a] for p in parts]) for a in keys}


def rows_length(rows: Dict[str, np.ndarray]) -> int:
    return next(iter(rows.values())).shape[0] if rows else 0
