"""Columnar relation store — the host substrate for the union sampler.

Port copy of ``repro.core.relation`` (numpy only; same arithmetic, so every
composite key and 128-bit fingerprint equals the reference's bit for bit).
A relation is a struct-of-arrays of dict-encoded ``int64`` columns; rows are
identified positionally.  Composite keys come from :func:`combine_columns`
(reversible mixed-radix packing when domains are small, 64-bit hash-mix
otherwise).  Tuple *values* (for set-union semantics) are summarised by
128-bit fingerprints — two independent 64-bit multiplicative-hash mixes —
used for host-side bookkeeping; the device probes of
:mod:`repro_torch.core.backends.torch_backend` compare 32-bit fingerprints
of the actual column values.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# 64-bit mixing (splitmix64 finalizer) — vectorised, overflow-safe via uint64.
# ---------------------------------------------------------------------------

_U64 = np.uint64


def mix64(x: np.ndarray, salt: int = 0) -> np.ndarray:
    """SplitMix64 finalizer over an int/uint array. Returns uint64."""
    z = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        z = z + _U64(0x9E3779B97F4A7C15) * _U64(salt + 1)
        z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
        z = z ^ (z >> _U64(31))
    return z


def fingerprint_columns(cols: Sequence[np.ndarray], salt: int = 0) -> np.ndarray:
    """Order-sensitive 64-bit fingerprint of a tuple of columns (row-wise)."""
    if not cols:
        raise ValueError("fingerprint of zero columns")
    acc = np.zeros(cols[0].shape[0], dtype=np.uint64)
    with np.errstate(over="ignore"):
        for i, c in enumerate(cols):
            acc = acc * _U64(0x100000001B3) ^ mix64(np.asarray(c), salt=salt * 1000 + i)
    return acc


def fingerprint128(cols: Sequence[np.ndarray]) -> np.ndarray:
    """(n, 2) uint64 — two independent 64-bit fingerprints per row."""
    return np.stack([fingerprint_columns(cols, salt=1), fingerprint_columns(cols, salt=2)], axis=1)


def combine_columns(cols: Sequence[np.ndarray]) -> np.ndarray:
    """Pack several int64 columns into one int64 composite key.

    Uses exact mixed-radix packing when the combined domain fits in 63 bits
    (reversible, collision-free); otherwise falls back to a 63-bit hash mix
    (collisions astronomically unlikely for our data scales; callers that
    need exactness verify candidates by comparing raw columns).
    """
    cols = [np.asarray(c, dtype=np.int64) for c in cols]
    if len(cols) == 1:
        return cols[0]
    return pack_columns(cols, key_widths(cols))


def key_widths(cols: Sequence[np.ndarray]) -> Optional[Tuple[int, ...]]:
    """The mixed-radix widths :func:`combine_columns` packs ``cols`` with
    (each column's maximum + 1), or None where it hashes them instead
    (a negative value, or a combined domain of 2**62 or more)."""
    widths = []
    for c in cols:
        c = np.asarray(c)
        if int(c.min(initial=0)) < 0:
            return None
        widths.append(max(int(c.max(initial=0)) + 1, 1))
    total = 1
    for w in widths:
        total *= w
    return tuple(widths) if total < (1 << 62) else None


def pack_columns(cols: Sequence[np.ndarray],
                 widths: Optional[Tuple[int, ...]]) -> np.ndarray:
    """Composite keys of ``cols`` packed with given mixed-radix ``widths``
    (None: the 63-bit hash mix).  A row with a value outside its width
    packs to -1, which no packed key equals.  One column passes through."""
    cols = [np.asarray(c, dtype=np.int64) for c in cols]
    if len(cols) == 1:
        return cols[0]
    if widths is None:
        return (fingerprint_columns(cols, salt=7).astype(np.int64)
                & np.int64(0x7FFFFFFFFFFFFFFF))
    out = np.zeros_like(cols[0])
    inside = np.ones(out.shape[0], dtype=bool)
    for c, w in zip(cols, widths):
        out = out * np.int64(w) + c
        inside &= (c >= 0) & (c < w)
    if not inside.all():
        out[~inside] = -1
    return out


# ---------------------------------------------------------------------------
# Relation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Relation:
    """A named, columnar relation with dict-encoded integer columns."""

    name: str
    columns: Dict[str, np.ndarray]

    def __post_init__(self) -> None:
        n = None
        fixed = {}
        for a, c in self.columns.items():
            c = np.asarray(c)
            if c.dtype not in (np.int64, np.int32):
                c = c.astype(np.int64)
            else:
                c = c.astype(np.int64, copy=False)
            if n is None:
                n = c.shape[0]
            elif c.shape[0] != n:
                raise ValueError(
                    f"column {a!r} of {self.name!r} has {c.shape[0]} rows, expected {n}"
                )
            fixed[a] = c
        self.columns = fixed
        self._nrows = 0 if n is None else int(n)

    # -- basic accessors ----------------------------------------------------
    @property
    def nrows(self) -> int:
        return self._nrows

    @property
    def attrs(self) -> List[str]:
        return list(self.columns.keys())

    def project(self, attrs: Sequence[str], name: Optional[str] = None) -> "Relation":
        return Relation(name or f"{self.name}[{','.join(attrs)}]",
                        {a: self.columns[a] for a in attrs})

    def filter(self, mask: np.ndarray, name: Optional[str] = None) -> "Relation":
        mask = np.asarray(mask)
        return Relation(name or self.name, {a: c[mask] for a, c in self.columns.items()})

    def with_column(self, attr: str, col: np.ndarray) -> "Relation":
        cols = dict(self.columns)
        cols[attr] = col
        return Relation(self.name, cols)

    def rename(self, mapping: Mapping[str, str], name: Optional[str] = None) -> "Relation":
        return Relation(name or self.name,
                        {mapping.get(a, a): c for a, c in self.columns.items()})

    def key(self, attrs: Sequence[str]) -> np.ndarray:
        """Composite key column over ``attrs`` (single column passes through)."""
        return combine_columns([self.columns[a] for a in attrs])

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"Relation({self.name!r}, rows={self.nrows}, attrs={self.attrs})"
