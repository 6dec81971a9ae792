"""Sorted-key indexes and per-column statistics (host side).

Port copy of ``repro.core.index`` (plus ``catalog_util.as_tuple``).  An
index over ``(relation, key)`` is ``(perm, sorted_vals)``: the argsort
permutation and the key column in sorted order.  Every host probe (``lo/hi``
range per query), degree lookup and EW aggregation reduces to
``np.searchsorted`` over these arrays.  A composite key's queries are
packed with the widths the index packed its own rows with
(:func:`query_keys`), so equal keys meet whatever the query side's maxima.
The device engine builds its own int32 copies
(:mod:`repro_torch.core.backends.torch_backend`) and probes them with the
CUDA kernels of :mod:`repro_torch.kernels.probe`.
:class:`RowSetIndex` is the host engine's membership index over whole rows
(sorted 128-bit row fingerprints, :mod:`repro_torch.core.membership`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np

from .relation import (Relation, combine_columns, fingerprint128, key_widths,
                       pack_columns)


def as_tuple(x: Union[str, Sequence[str], None]) -> Tuple[str, ...]:
    if x is None:
        return ()
    if isinstance(x, str):
        return (x,)
    return tuple(x)


@dataclasses.dataclass
class SortedIndex:
    """Sorted index of one (possibly composite) key column of a relation."""

    relation: str
    key_attrs: Tuple[str, ...]
    perm: np.ndarray          # (n,) int64 row ids in sorted key order
    sorted_vals: np.ndarray   # (n,) int64 sorted keys
    # a composite key's mixed-radix widths (None: one attribute, or hashed)
    widths: Optional[Tuple[int, ...]] = None
    _max_degree: Optional[int] = dataclasses.field(default=None, repr=False,
                                                   compare=False)

    def ranges(self, queries: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Per-query [lo, hi) positions in the sorted order."""
        q = np.asarray(queries)
        lo = np.searchsorted(self.sorted_vals, q, side="left")
        hi = np.searchsorted(self.sorted_vals, q, side="right")
        return lo, hi

    def contains(self, queries: np.ndarray) -> np.ndarray:
        lo, hi = self.ranges(queries)
        return hi > lo

    def row_ids_at(self, pos: np.ndarray) -> np.ndarray:
        """Row ids of sorted positions (for gathering matched rows)."""
        return self.perm[np.asarray(pos)]

    @property
    def nrows(self) -> int:
        return int(self.sorted_vals.shape[0])

    def value_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        """(unique values, per-value degree) — the exact 'histogram'."""
        vals, counts = np.unique(self.sorted_vals, return_counts=True)
        return vals, counts

    def max_degree(self) -> int:
        """Largest per-value degree, computed once: the estimators' pivot
        rule reads it (through ``olken_bound``) on every walk batch."""
        if self._max_degree is None:
            self._max_degree = (0 if self.nrows == 0
                                else int(self.value_counts()[1].max()))
        return self._max_degree


def query_keys(index, cols: Sequence[np.ndarray]) -> np.ndarray:
    """Keys of the query columns for ``index.ranges``, packed with the
    widths the index packed its rows with, so a query outside the index's
    domain is a miss.  An index without widths (a catalog of the reference
    package, which packs each side with its own maxima) gets
    :func:`combine_columns`, as that catalog's own probes do."""
    if not hasattr(index, "widths"):
        return combine_columns(cols)
    return pack_columns(cols, index.widths)


def build_index(rel: Relation, key_attrs: Sequence[str]) -> SortedIndex:
    cols = [rel.columns[a] for a in key_attrs]
    widths = key_widths(cols) if len(cols) > 1 else None
    key = pack_columns(cols, widths)
    perm = np.argsort(key, kind="stable")
    return SortedIndex(rel.name, tuple(key_attrs), perm.astype(np.int64),
                       key[perm], widths)


@dataclasses.dataclass
class RowSetIndex:
    """Membership index over whole rows of a relation (projected sub-tuples).

    Sorted 64-bit primary fingerprints + secondary fingerprints for
    verification: a probe matches iff the primary fp is found AND one of the
    candidates' secondary fps matches (128 bits in all).
    """

    relation: str
    attrs: Tuple[str, ...]
    sorted_fp1: np.ndarray
    fp2_in_fp1_order: np.ndarray

    def contains_rows(self, rows: Dict[str, np.ndarray]) -> np.ndarray:
        cols = [np.asarray(rows[a]) for a in self.attrs]
        fp = fingerprint128(cols)
        lo = np.searchsorted(self.sorted_fp1, fp[:, 0], side="left")
        hi = np.searchsorted(self.sorted_fp1, fp[:, 0], side="right")
        out = np.zeros(fp.shape[0], dtype=bool)
        # verify secondaries; ranges are tiny (fp collisions ~ none)
        span = hi - lo
        simple = span <= 1
        pos = np.clip(lo, 0, max(self.sorted_fp1.shape[0] - 1, 0))
        if self.sorted_fp1.shape[0]:
            out[simple] = (span[simple] == 1) & (
                self.fp2_in_fp1_order[pos[simple]] == fp[simple, 1])
        for i in np.nonzero(~simple)[0]:
            out[i] = bool(np.any(self.fp2_in_fp1_order[lo[i]:hi[i]]
                                 == fp[i, 1]))
        return out


def build_rowset_index(rel: Relation, attrs: Sequence[str]) -> RowSetIndex:
    attrs = tuple(attrs)
    fp = fingerprint128([rel.columns[a] for a in attrs])
    order = np.argsort(fp[:, 0], kind="stable")
    return RowSetIndex(rel.name, attrs, fp[order, 0], fp[order, 1])


@dataclasses.dataclass
class ColumnStats:
    distinct: int
    max_degree: int
    avg_degree: float
    # exact per-value histogram (what a DBMS histogram approximates)
    hist_values: np.ndarray
    hist_counts: np.ndarray


class Catalog:
    """Caches sorted indexes, row-set indexes and column statistics."""

    def __init__(self) -> None:
        self._indexes: Dict[Tuple[str, Tuple[str, ...]], SortedIndex] = {}
        self._rowsets: Dict[Tuple[str, Tuple[str, ...]], RowSetIndex] = {}
        self._stats: Dict[Tuple[str, Tuple[str, ...]], ColumnStats] = {}
        self._relations: Dict[str, Relation] = {}   # planner.plan_key reads it

    def index(self, rel: Relation, key_attrs: Sequence[str]) -> SortedIndex:
        self._relations[rel.name] = rel
        k = (rel.name, tuple(key_attrs))
        if k not in self._indexes:
            self._indexes[k] = build_index(rel, key_attrs)
        return self._indexes[k]

    def rowset(self, rel: Relation, attrs: Sequence[str]) -> RowSetIndex:
        self._relations[rel.name] = rel
        k = (rel.name, tuple(sorted(attrs)))
        if k not in self._rowsets:
            self._rowsets[k] = build_rowset_index(rel, sorted(attrs))
        return self._rowsets[k]

    def stats(self, rel: Relation, key_attrs: Sequence[str]) -> ColumnStats:
        k = (rel.name, tuple(key_attrs))
        if k not in self._stats:
            idx = self.index(rel, key_attrs)
            vals, counts = idx.value_counts()
            self._stats[k] = ColumnStats(
                distinct=int(vals.shape[0]),
                max_degree=int(counts.max()) if counts.shape[0] else 0,
                avg_degree=float(counts.mean()) if counts.shape[0] else 0.0,
                hist_values=vals,
                hist_counts=counts,
            )
        return self._stats[k]
