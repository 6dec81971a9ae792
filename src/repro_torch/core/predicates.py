"""§8.3: selection predicates — pushdown and rejection modes.

Port copy of ``repro.core.predicates``:

* ``pushdown(spec, preds)`` filters base relations during preprocessing and
  returns a new :class:`JoinSpec` over the filtered relations.  The returned
  spec carries **provenance** (``pushdown_base`` + ``pushed_preds``) so the
  device engine can rebuild the same filtered join as per-relation validity
  *masks* over the unfiltered base relations — masked EW prefix sums instead
  of relation copies — and share the base sorted indexes across predicate
  flavours (the UQ2 regime: one base join, several overlapping filters).
* ``rejection(spec, preds)`` attaches sampler-side **per-join** predicates
  (``JoinSpec.reject_preds``): candidates failing them are rejected during
  sampling (counted in ``SamplerStats.pred_rejects``).  Membership probes
  and exact/histogram size estimation consume ``reject_preds`` as well, so
  the filtered join is what gets sampled.
* ``RejectingPredicate`` wraps a *union-wide* sampler-side filter (the same
  predicate applied to every member join).

Predicates are column comparisons on the dict-encoded domain:
``Pred(attr, op, value)`` with op in {==, !=, <, <=, >, >=, in}.
:func:`compile_preds_torch` lowers exactly these ops over int32 values; the
port has no host engine, so anything else is refused with the
:func:`device_lower_reason` words.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from .joins import JoinNode, JoinSpec
from .relation import Relation

_OPS: Dict[str, Callable[[np.ndarray, object], np.ndarray]] = {
    "==": lambda c, v: c == v,
    "!=": lambda c, v: c != v,
    "<": lambda c, v: c < v,
    "<=": lambda c, v: c <= v,
    ">": lambda c, v: c > v,
    ">=": lambda c, v: c >= v,
    "in": lambda c, v: np.isin(c, np.asarray(list(v))),
}

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class Pred:
    attr: str
    op: str
    value: object

    def mask(self, cols: Dict[str, np.ndarray]) -> np.ndarray:
        return _OPS[self.op](np.asarray(cols[self.attr]), self.value)


def pred_mask_np(preds: Sequence[Pred], rows: Dict[str, np.ndarray]) -> np.ndarray:
    """AND-reduced host mask of ``preds`` over a batch of output tuples."""
    n = next(iter(rows.values())).shape[0]
    keep = np.ones(n, dtype=bool)
    for p in preds:
        keep &= p.mask(rows)
    return keep


def relation_mask(rel: Relation, preds: Sequence[Pred]) -> Optional[np.ndarray]:
    """Validity mask of ``preds`` restricted to ``rel``'s attributes, or
    ``None`` when no predicate touches the relation (the rule
    :func:`pushdown` filters by, exposed for the device mask build)."""
    mask = None
    for p in preds:
        if p.attr in rel.attrs:
            m = p.mask(rel.columns)
            mask = m if mask is None else mask & m
    return mask


def _pred_tag(preds: Sequence[Pred]) -> str:
    """Deterministic 8-hex signature of a predicate list (filtered-relation
    names must be unique per filter — :class:`Catalog` caches indexes by
    relation name — yet shared across joins pushing the *same* filter)."""
    parts = []
    for p in preds:
        v = (tuple(sorted(int(x) for x in p.value)) if p.op == "in"
             else p.value)
        parts.append((p.attr, p.op, v))
    return hashlib.blake2s(repr(parts).encode(), digest_size=4).hexdigest()


def pushdown(spec: JoinSpec, preds: Sequence[Pred],
             name_suffix: str = "#sel", name: Optional[str] = None) -> JoinSpec:
    """Filter each base relation by the predicates touching its attributes.

    The result records provenance: ``out.pushdown_base`` is the unfiltered
    spec (composing across chained pushdowns) and ``out.pushed_preds`` the
    accumulated filter list — the device engine rebuilds the filtered join
    from these as validity masks over the base relations.
    """
    nodes: List[JoinNode] = []
    for n in spec.nodes:
        rel = n.relation
        mask = relation_mask(rel, preds)
        if mask is not None:
            applicable = [p for p in preds if p.attr in rel.attrs]
            new_rel = rel.filter(
                mask, name=f"{rel.name}{name_suffix}{_pred_tag(applicable)}")
        else:
            new_rel = rel
        nodes.append(JoinNode(n.alias, new_rel, n.parent, n.edge_attrs, n.kind))
    out = JoinSpec(name if name is not None else spec.name + name_suffix, nodes)
    out.pushdown_base = spec.pushdown_base if spec.pushdown_base is not None else spec
    out.pushed_preds = tuple(spec.pushed_preds) + tuple(preds)
    out.reject_preds = tuple(spec.reject_preds)
    return out


def rejection(spec: JoinSpec, preds: Sequence[Pred],
              name: Optional[str] = None) -> JoinSpec:
    """Attach per-join §8.3 rejection predicates (no relation filtering).

    The returned spec shares ``spec``'s nodes; samplers reject candidates
    failing ``preds``, membership probes AND the predicate mask, and size
    estimation scales by :func:`selectivity_factor` — so the *filtered* join
    is the set-union member everywhere.
    """
    out = JoinSpec(name if name is not None else spec.name + "#rej",
                   list(spec.nodes))
    out.pushdown_base = spec.pushdown_base
    out.pushed_preds = tuple(spec.pushed_preds)
    out.reject_preds = tuple(spec.reject_preds) + tuple(preds)
    return out


class RejectingPredicate:
    """Union-wide sampler-side predicate: rejection factor = selectivity
    (§8.3 mode 2, applied identically to every member join)."""

    def __init__(self, preds: Sequence[Pred]):
        self.preds = list(preds)

    def accept(self, rows: Dict[str, np.ndarray]) -> np.ndarray:
        return pred_mask_np(self.preds, rows)


# ---------------------------------------------------------------------------
# Device lowering (dict-encoded int32 domain)
# ---------------------------------------------------------------------------


def device_lower_reason(preds: Sequence[Pred],
                        attrs: Optional[Sequence[str]] = None) -> Optional[str]:
    """Why ``preds`` cannot run inside the device round (``None`` = they can).

    Device rows are int32 dict codes, so only integer comparisons within the
    int32 domain lower.
    """
    def _int_ok(v) -> bool:
        return (isinstance(v, (int, np.integer))
                and not isinstance(v, bool)
                and _I32_MIN <= int(v) <= _I32_MAX)

    for p in preds:
        if p.op not in _OPS:
            return f"unknown predicate op {p.op!r}"
        if attrs is not None and p.attr not in attrs:
            return f"predicate attr {p.attr!r} not in the join output schema"
        if p.op == "in":
            try:
                vals = list(p.value)
            except TypeError:
                return f"'in' predicate value {p.value!r} is not iterable"
            if not all(_int_ok(v) for v in vals):
                return "'in' predicate values outside the int32 dict domain"
        elif not _int_ok(p.value):
            return (f"predicate value {p.value!r} outside the int32 dict "
                    "domain")
    return None


def compile_preds_torch(preds: Sequence[Pred],
                        attrs: Optional[Sequence[str]] = None):
    """Compile ``preds`` to a mask function over device candidate rows.

    Returns ``fn(rows: Dict[str, int32 tensor]) -> bool tensor`` (the AND of
    all predicates), or raises ``ValueError`` with the
    :func:`device_lower_reason` when the predicates cannot lower.  The
    constants are bound as int32 here; an ``in`` set is uploaded once per
    device.
    """
    reason = device_lower_reason(preds, attrs)
    if reason is not None:
        raise ValueError(f"predicate not device-lowerable: {reason}")
    import torch

    bound = []
    for p in preds:
        if p.op == "in":
            vals = np.unique(np.asarray(sorted(int(v) for v in p.value),
                                        dtype=np.int32))
            bound.append((p.attr, "in", vals))
        else:
            bound.append((p.attr, p.op, int(np.int32(int(p.value)))))
    sets: Dict = {}

    def _set(vals, device):
        k = (id(vals), device)
        if k not in sets:
            sets[k] = torch.as_tensor(vals, device=device)
        return sets[k]

    def fn(rows):
        keep = None
        for attr, op, val in bound:
            c = rows[attr]
            if op == "in":
                # a lookup in the sorted set: no data-dependent sizes (the
                # sorting path of torch.isin runs torch.unique, which syncs
                # with the host and cannot be captured in a CUDA graph)
                if val.size == 0:
                    m = torch.zeros(c.shape, dtype=torch.bool, device=c.device)
                else:
                    vs = _set(val, c.device)
                    pos = torch.searchsorted(vs, c)
                    m = vs[torch.clamp(pos, max=val.size - 1)] == c
            elif op == "==":
                m = c == val
            elif op == "!=":
                m = c != val
            elif op == "<":
                m = c < val
            elif op == "<=":
                m = c <= val
            elif op == ">":
                m = c > val
            else:
                m = c >= val
            keep = m if keep is None else keep & m
        if keep is None:
            c = next(iter(rows.values()))
            keep = torch.ones(c.shape, dtype=torch.bool, device=c.device)
        return keep

    return fn


# ---------------------------------------------------------------------------
# Predicate-aware size estimation (§5 bounds under rejection predicates)
# ---------------------------------------------------------------------------


def selectivity_factor(spec: JoinSpec) -> float:
    """Estimated fraction of ``spec``'s join rows surviving its
    ``reject_preds`` (1.0 when there are none).

    Per predicate: the surviving-row fraction of the most selective base
    relation holding the attribute; factors multiply across predicates.  An
    *estimate*, not a bound — join fan-out can correlate with predicate
    columns — but it keeps §5 histogram bounds and the Olken bound from
    overestimating filtered pieces by 1/selectivity.
    """
    preds = spec.reject_preds
    if not preds:
        return 1.0
    cached = spec.__dict__.get("_sel_factor")
    if cached is not None:
        return cached
    f = 1.0
    for p in preds:
        frac = 1.0
        for n in spec.nodes:
            rel = n.relation
            if p.attr in rel.attrs and rel.nrows > 0:
                frac = min(frac, float(p.mask(rel.columns).sum()) / rel.nrows)
        f *= frac
    spec.__dict__["_sel_factor"] = f
    return f


def scaled_overlap_estimate(fn):
    """Wrap an overlap estimator ``fn(delta) -> float`` so overlaps of joins
    carrying ``reject_preds`` are scaled by the most selective member's
    :func:`selectivity_factor`."""
    def est(delta):
        v = float(fn(delta))
        f = min((selectivity_factor(j) for j in delta), default=1.0)
        return v * f
    return est


def scaled_size_fn(fn):
    """Wrap a join-size estimator ``fn(join) -> float`` with the per-join
    :func:`selectivity_factor`."""
    def size(j):
        return float(fn(j)) * selectivity_factor(j)
    return size
