"""The comparison that decides ``correct``: served rows against the plain
reference that the configuration names (any object with the
:class:`Reference` interface, such as
:class:`unionbench.reference.chain_union.ChainUnion`).

It judges what the timed path handed to clients and works out everything
it compares with from the inputs alone:

* ``request_size_errors`` — requests that got another number of rows than
  they asked for (every request of the window; the serve tier);
* ``rows_not_in_home`` — checked rows that are not a tuple of the join
  they are credited to: a base row missing or altered, a variant row the
  join does not keep, or a pushdown predicate that fails (the draws);
* ``rows_in_earlier_piece`` — checked rows of their home join that also
  lie in a join earlier in the cover (the membership layer);
* ``home_z`` — the largest binomial z of a piece's share of the checked
  rows against the exact law ``|J'_k| / Σ|J'|``;
* ``law_z`` — within each piece, the rows' base row at each node of its
  join against
  the exact marginal law of a uniform sample of the piece: a Pearson
  chi-square over cells that pool rows by a fixed hash until a cell
  expects about ``CELL`` rows, as ``(X² - df) / sqrt(2 df)``; the largest
  over pieces and nodes;
* ``union_law_z`` — the same per node name over (piece, cell) pairs, the
  pieces whose joins hold that node, against the exact law of a uniform
  sample of the whole union, piece shares included (the cover and
  selection law where the cover is exact);
* ``dup_z`` — repeated tuples within a piece against what i.i.d. uniform
  draws repeat (``C(n_k, 2) / |J'_k|`` pairs, Poisson variance):
  ``(observed - expected) / sqrt(variance)`` (independence).
"""

from __future__ import annotations

from typing import Dict, List, Protocol, Sequence, Tuple

import numpy as np

CELL = 20            # expected rows per pooled cell of law_z

Rows = Dict[str, np.ndarray]


class Reference(Protocol):
    """What the judge reads of a reference.  Join ``k`` is the ``k``-th in
    cover order; a node is named by its relation, and a name means the
    same relation (the same rows) in every join that holds it."""

    def nodes(self, k: int) -> Sequence[str]:
        """Join ``k``'s node names."""

    def node_rows(self, k: int) -> Sequence[int]:
        """The row count of each of join ``k``'s nodes."""

    def locate(self, rows: Rows, k: int) -> np.ndarray:
        """(n, len(nodes(k))) base row of each of join ``k``'s nodes for
        each served row (by primary key, every column compared), -1 where
        the relation holds no row equal to the row's projection."""

    def member(self, rows: Rows, q: int) -> np.ndarray:
        """Whether each served row is a tuple of join ``q``."""

    def pieces(self) -> Tuple[np.ndarray, List[List[np.ndarray]]]:
        """Exact piece sizes ``|J'_k|`` in cover order, and per piece and
        node of its own join the piece's tuples through each row."""


def _cells(nz: np.ndarray, count: int) -> np.ndarray:
    """Cell of each row with weight: its own where that is few enough,
    else a fixed hash of its position into ``count`` cells."""
    rank = np.cumsum(nz) - 1
    if count >= int(nz.sum()):
        return rank[nz]
    h = (rank[nz].astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) >> np.uint64(24)
    return (h % np.uint64(count)).astype(np.int64)


def _pooled(obs: np.ndarray, q: np.ndarray, n: float
            ) -> Tuple[np.ndarray, np.ndarray]:
    """Observed and expected rows per pooled cell, for ``n`` expected draws
    from the law ``q`` (sums to 1) over base rows; rows of zero weight are
    left to the membership numbers."""
    nz = q > 0
    cells = max(1, min(int(nz.sum()), int(n // CELL)))
    c = _cells(nz, cells)
    e = np.bincount(c, weights=q[nz] * n, minlength=cells)
    o = np.bincount(c, weights=obs[nz], minlength=cells)
    use = e > 0
    return o[use], e[use]


def _z(o: np.ndarray, e: np.ndarray) -> float:
    """Pearson chi-square as ``(X² - df) / sqrt(2 df)``."""
    df = o.size - 1
    if df < 1:
        return 0.0
    x2 = float(((o - e) ** 2 / e).sum())
    return (x2 - df) / np.sqrt(2.0 * df)


def judge(ref: Reference, asked: Sequence[int], got: Sequence[int],
          rows: Rows, home: np.ndarray,
          names: Sequence[str]) -> Tuple[Dict[str, float], Dict[str, object]]:
    """The numbers in ``names`` for one run, and details for the log.

    ``asked``/``got`` cover every request of the window; ``rows``/``home``
    are the checked rows (home in cover order)."""
    asked = np.asarray(asked, np.int64)
    got = np.asarray(got, np.int64)
    home = np.asarray(home, np.int64)
    sizes, marg = ref.pieces()
    nj = len(sizes)
    out: Dict[str, float] = {}
    info: Dict[str, object] = {"checked_rows": int(home.size)}
    out["request_size_errors"] = int((asked != got).sum())
    known = (home >= 0) & (home < nj)
    in_home = np.zeros(home.size, bool)
    earlier = np.zeros(home.size, bool)
    located: List[Tuple[np.ndarray, np.ndarray]] = []   # per home piece
    for k in range(nj):
        sel = np.flatnonzero(known & (home == k))
        sub = {a: c[sel] for a, c in rows.items()}
        located.append((sel, ref.locate(sub, k)))
        if sel.size == 0:
            continue
        in_home[sel] = ref.member(sub, k)
        for q in range(k):
            earlier[sel] |= ref.member(sub, q)
    out["rows_not_in_home"] = int((~in_home).sum())
    out["rows_in_earlier_piece"] = int((in_home & earlier).sum())
    valid = in_home & ~earlier
    p = sizes / sizes.sum()
    n = int(home.size)
    counts = np.bincount(home[known], minlength=nj)[:nj].astype(np.float64)
    sd = np.sqrt(np.maximum(n * p * (1 - p), 1.0))
    out["home_z"] = float(np.max(np.abs(counts - n * p) / sd)) if n else 0.0
    share = counts / max(n, 1)
    info["home_share"] = share.round(6).tolist()
    info["exact_share"] = p.round(6).tolist()
    with np.errstate(divide="ignore", invalid="ignore"):
        gap = np.where(p > 0, np.abs(share / p - 1), 0.0)
    info["home_share_gap"] = float(gap.max())
    law, where = 0.0, None
    nv = int(valid.sum())
    joint: Dict[str, Tuple[list, list]] = {}
    for k in range(nj):
        for name in ref.nodes(k):
            joint.setdefault(name, ([], []))
    pairs_obs = pairs_exp = pairs_var = 0.0
    for k in range(nj):
        sel, ids = located[k]
        keep = valid[sel]
        nk = int(keep.sum())
        if sizes[k] <= 0:
            continue
        kid = ids[keep]
        for node, (name, nrows) in enumerate(zip(ref.nodes(k), ref.node_rows(k))):
            obs = np.bincount(kid[:, node], minlength=nrows)
            q = marg[k][node] / sizes[k]
            if nk:
                z = _z(*_pooled(obs, q, nk))
                if where is None or z > law:
                    law, where = z, (k, name)
            o, e = _pooled(obs, q, nv * p[k])
            joint[name][0].append(o)
            joint[name][1].append(e)
        if nk == 0:
            continue
        _, rep = np.unique(kid, axis=0, return_counts=True)
        pairs_obs += float((rep * (rep - 1) / 2).sum())
        mu = nk / sizes[k]
        pairs_exp += nk * (nk - 1) / 2 / sizes[k]
        pairs_var += sizes[k] * (mu ** 3 + mu ** 2 / 2)
    out["law_z"] = float(law)
    info["law_z_at"] = where
    held = [name for name, (o, _) in joint.items() if o]
    zs = [_z(np.concatenate(joint[x][0]), np.concatenate(joint[x][1]))
          for x in held]
    out["union_law_z"] = float(max(zs))
    info["union_law_z_at"] = held[int(np.argmax(zs))]
    out["dup_z"] = ((pairs_obs - pairs_exp) / np.sqrt(pairs_var)
                    if pairs_var > 0 else 0.0)
    info["dup_pairs"] = [pairs_obs, round(pairs_exp, 3)]
    info["all"] = {k: float(v) for k, v in out.items()}
    missing = [x for x in names if x not in out]
    if missing:
        raise KeyError(f"no comparison named {missing}")
    return {x: out[x] for x in names}, info


def passes(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (an exact comparison's is 0)."""
    return all(np.isfinite(v) and v <= limits[k] for k, v in numbers.items())
