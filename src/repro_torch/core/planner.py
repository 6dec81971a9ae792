"""Cost-driven round planning for the Algorithm-1 engine.

Port copy of ``repro.core.planner``.  Two cooperating pieces:

* **Fixed-point EMA arithmetic** shared by the host (numpy) and the device
  carry (torch, through :data:`TORCH_XP`).  Per-piece acceptance rates are
  carried as ``(nj, 4)`` int32 arrays in units of ``EMA_ONE == 2**16`` —
  columns are ``(accept, walk_ok, residual, pred)`` fractions of the slots
  budgeted to the piece that round.  Every operation is an integer add /
  shift / floor-divide, so numpy and torch compute **bit-identical** budgets
  from identical counts.  Budgets depend only on carried counts (owed work,
  bank occupancy, acceptance EMAs) — never on sample *values* — which keeps
  the shortfall carry uniform: the accepted candidates inside a round are
  i.i.d. and masking a count-derived prefix of draw slots cannot bias them.

* **A host-side cost model** (:class:`PlanCache`) that autotunes
  ``round_batch`` / ``surplus_cap`` / drain window per (catalog, workload,
  capacity class) from timed calls, as ``t_round = c0 + c1 * slots``.  The
  engine feeds it after each timed ``sample()``; ``SetUnionSampler`` consults
  it when built with ``round_batch=None``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .predicates import selectivity_factor

# -- fixed-point constants ----------------------------------------------------

EMA_ONE = 1 << 16          # fixed-point scale: 65536 == acceptance rate 1.0
EMA_ALPHA_SHIFT = 3        # ema += (rate - ema) >> 3   (alpha = 1/8)
EMA_FLOOR = 1 << 10        # ~1.6% assumed minimum acceptance when budgeting
BUDGET_FLOOR = 32          # keep starved pieces probing even when ema says no
NEED_CLAMP = 1 << 14       # clamp need before *EMA_ONE so int32 cannot overflow
EMA_COMPONENTS = ("accept", "walk_ok", "residual", "pred")


class _TorchXP:
    """The handful of array functions :func:`budget_for` and
    :func:`ema_update` call, for torch tensors.  A Python scalar stays a
    scalar (``clamp``, ``>>``, ``where``), so no constant is copied to the
    device; ``torch.clamp`` takes one kind of bound, so a tensor bound goes
    through ``torch.minimum``/``torch.maximum``.  The shift is arithmetic
    (``bitwise_right_shift``), as numpy's and jnp's are on int32."""

    @staticmethod
    def minimum(a, b):
        import torch
        return (torch.minimum(a, b) if isinstance(b, torch.Tensor)
                else torch.clamp(a, max=b))

    @staticmethod
    def maximum(a, b):
        import torch
        return (torch.maximum(a, b) if isinstance(b, torch.Tensor)
                else torch.clamp(a, min=b))

    def clip(self, x, lo, hi):
        return self.minimum(self.maximum(x, lo), hi)

    @staticmethod
    def right_shift(x, s):
        import torch
        return torch.bitwise_right_shift(x, s)

    @staticmethod
    def where(c, a, b):
        import torch
        return torch.where(c, a, b)


TORCH_XP = _TorchXP()


def ema_shifts(piece_batches: Sequence[int]) -> np.ndarray:
    """Static per-piece right-shifts so ``count * EMA_ONE`` stays in int32.

    A piece that may draw ``B`` slots per round needs ``B >> s <= 2**14 - 1``
    before the ``* EMA_ONE`` (``2**16``) scale-up.
    """
    return np.asarray(
        [max(0, int(b).bit_length() - 14) for b in piece_batches], np.int32
    )


def seed_rates(cover, specs: Dict[str, object]) -> np.ndarray:
    """(nj, 4) int32 EMA seed so round 1 is not cold.

    Column 0 (accept) seeds from the cover — ``piece_size / join_size`` is
    the probability that a uniform draw from join *j* lands in piece *j* —
    scaled by the §8.3 ``selectivity_factor`` for rejection-mode unions
    where draws come from the unfiltered tree.  Column 3 seeds the
    complementary predicate-reject fraction; walk_ok starts optimistic and
    residual at 0 — both converge within a few EMA steps on cyclic joins.
    """
    rows = []
    for name in cover.order:
        js = max(float(cover.join_sizes.get(name, 0.0)), 1e-9)
        ps = max(float(cover.piece_sizes.get(name, 0.0)), 0.0)
        frac = min(max(ps / js, 1.0 / 64.0), 1.0)
        sf = 1.0
        spec = specs.get(name)
        if spec is not None:
            try:
                sf = float(selectivity_factor(spec))
            except (KeyError, TypeError, ValueError):
                sf = 1.0
        acc = min(max(frac * sf, 1.0 / 64.0), 1.0)
        pred = min(max(1.0 - sf, 0.0), 1.0)
        rows.append(
            [int(round(acc * EMA_ONE)), EMA_ONE, 0, int(round(pred * EMA_ONE))]
        )
    return np.asarray(rows, np.int32)


# adaptive selection-slot expansion: slots per round = round_batch * 9/4, to
# amortise the fixed per-round cost over more emission targets; the widths
# that supply those slots come from alloc_batches, so the extra slots are
# backed by expected accepts, not by padding
SLOT_EXPANSION = (9, 4)


def adaptive_slot(round_batch: int) -> int:
    num, den = SLOT_EXPANSION
    return max(int(round_batch), (int(round_batch) * num) // den)


def alloc_batches(base_batches: Sequence[int], probs, ema_seed_accept,
                  slot_width: int, *, granule: int = 32,
                  floor: int = 64) -> Tuple[int, ...]:
    """Demand-matched adaptive draw widths (fixed at build).

    The expected per-round demand on piece *j* is ``slot_width * p_j`` and
    the draws needed to supply it ``demand / acc_j`` (seeded acceptance);
    each width is that, to the nearest ``granule``, at least ``floor`` and at
    most ``slot_width``.  A round that comes up short carries the shortfall
    and the surplus banks buffer over-supplied rounds.  Only cover
    statistics and the EMA *seeds* enter, never sample values.
    ``base_batches`` only fixes the piece count.
    """
    p = np.maximum(np.asarray(probs, np.float64), 0)
    s = p.sum()
    if s > 0:
        p = p / s
    acc = np.maximum(np.asarray(ema_seed_accept, np.float64),
                     float(EMA_FLOOR)) / float(EMA_ONE)
    out = []
    for j in range(len(base_batches)):
        want = int(np.ceil(slot_width * p[j] / acc[j]))
        w = max(int(floor), ((want + granule // 2) // granule) * granule)
        out.append(int(min(int(slot_width), w)))
    return tuple(out)


def budget_for(need, bank_count, ema_accept, bmax, drain_w, xp):  # analysis: fixed-point
    """Integer candidate budget per piece — identical under numpy and torch.

    ``need`` minus usable bank coverage, divided by the accept EMA (ceil),
    plus 12.5% headroom; floored at :data:`BUDGET_FLOOR` while the piece
    still owes work and capped at its static draw width.  All int32; pass
    ``np`` or :data:`TORCH_XP` as ``xp``.
    """
    cover = xp.minimum(bank_count, drain_w)
    need_eff = xp.clip(need - cover, 0, NEED_CLAMP)
    e = xp.maximum(ema_accept, EMA_FLOOR)
    desired = (need_eff * EMA_ONE + e - 1) // e
    desired = desired + xp.right_shift(desired, 3)
    b = xp.clip(desired, BUDGET_FLOOR, bmax)
    return xp.where(need_eff > 0, b, 0)


def ema_update(ema, drawn, counts, shifts, xp):  # analysis: fixed-point
    """One EMA step from this round's per-piece counts (all int32).

    ``counts`` is ``(nj, 4)`` — (accepted, walk_ok, residual, pred) — and
    ``drawn`` the per-piece budget actually eligible this round.  Pieces
    with ``drawn == 0`` keep their EMA.  ``shifts`` pre-scales both sides of
    the ratio so ``count * EMA_ONE`` cannot overflow int32; ``rate - ema``
    may be negative, and its shift is arithmetic.
    """
    ds = xp.right_shift(drawn, shifts)
    rate = (xp.right_shift(counts, shifts[:, None]) * EMA_ONE) // xp.maximum(
        ds, 1
    )[:, None]
    upd = ema + xp.right_shift(rate - ema, EMA_ALPHA_SHIFT)
    return xp.where((drawn > 0)[:, None], upd, ema)


# -- host planner for the online-union fresh-draw path ------------------------


class PiecePlanner:
    """Host-side planner state of the online union sampler (its port comes
    with the estimators).

    The same (nj, 4) fixed-point EMAs as the device carry, driving the size
    of the batched fresh draw each retry makes under ``plan="adaptive"``:
    ``ceil(1/ema_accept)`` candidates (plus headroom) so one retry round
    yields ~1 accepted sample in expectation.  φ-refresh events reseed it.
    """

    def __init__(self, cover, specs: Dict[str, object],
                 max_batch: int = 64) -> None:
        self.max_batch = int(max_batch)
        self.refreshes = 0
        self.reseed(cover, specs)

    def reseed(self, cover, specs: Dict[str, object]) -> None:
        self.ema = seed_rates(cover, specs)
        self.refreshes += 1

    def suggest_batch(self, oidx: int) -> int:
        e = max(int(self.ema[oidx, 0]), EMA_FLOOR)
        k = -(-EMA_ONE // e)          # ceil(1 / ema_accept)
        k = k + (k >> 3)
        return max(1, min(k, self.max_batch))

    def observe(self, oidx: int, drawn: int, accepted: int,
                pred_rejects: int = 0) -> None:
        if drawn <= 0:
            return
        row = self.ema[oidx:oidx + 1]
        counts = np.asarray(
            [[accepted, drawn, 0, pred_rejects]], np.int32
        )
        # walk_ok stays pinned at ``drawn``: the host draw path only
        # surfaces completed candidates, so walk failures are invisible
        sh = np.zeros(1, np.int32)
        self.ema[oidx:oidx + 1] = ema_update(
            row, np.asarray([drawn], np.int32), counts, sh, np
        )


# -- autotuning cost model ----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RoundPlan:
    """One autotuned knob set for a (workload, capacity class)."""

    round_batch: int
    surplus_cap: int
    drain_window: int


@dataclasses.dataclass
class _Obs:
    slots: int          # candidate slots per round at this round_batch
    rounds: int
    seconds: float
    samples: int

    @property
    def t_round(self) -> float:
        return self.seconds / max(self.rounds, 1)

    @property
    def emitted_per_round(self) -> float:
        return self.samples / max(self.rounds, 1)


def plan_key(cat, joins, cover, capacity: int = 0) -> str:
    """Catalog fingerprint + workload signature + capacity class."""
    h = hashlib.sha1()
    rels = getattr(cat, "_relations", {})
    for name in sorted(rels):
        h.update(f"{name}:{rels[name].nrows};".encode())
    for j in joins:
        h.update(f"{getattr(j, 'name', j)},".encode())
    h.update("|".join(cover.order).encode())
    h.update(f"|C{int(capacity)}".encode())
    return h.hexdigest()


_RB_CANDIDATES = (256, 512, 1024, 2048, 4096, 8192)


class PlanCache:
    """Process-global cache of timed-call observations and suggested plans.

    Keeps the fastest (min seconds/sample) observation per (key, round_batch)
    so the warm-up-polluted first call is displaced as soon as a warm call
    lands.  With one observed round_batch the ``c0``/``c1`` split falls back
    to a fixed 40/60 overhead prior; with two or more it is a least-squares
    fit of ``t_round = c0 + c1 * slots``.
    """

    _OVERHEAD_PRIOR = 0.4

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._obs: Dict[str, Dict[int, _Obs]] = {}

    def reset(self) -> None:
        with self._lock:
            self._obs.clear()

    def observe(self, key: str, round_batch: int, slots: int, rounds: int,
                seconds: float, samples: int) -> None:
        if rounds <= 0 or samples <= 0 or seconds <= 0.0:
            return
        o = _Obs(int(slots), int(rounds), float(seconds), int(samples))
        with self._lock:
            bucket = self._obs.setdefault(key, {})
            prev = bucket.get(int(round_batch))
            if prev is None or o.seconds / o.samples < prev.seconds / prev.samples:
                bucket[int(round_batch)] = o

    def fit(self, key: str) -> Optional[Tuple[float, float]]:
        """(c0, c1) of ``t_round = c0 + c1 * slots``, or None if no data."""
        with self._lock:
            bucket = dict(self._obs.get(key, {}))
        if not bucket:
            return None
        if len(bucket) == 1:
            (o,) = bucket.values()
            c0 = self._OVERHEAD_PRIOR * o.t_round
            return c0, (o.t_round - c0) / max(o.slots, 1)
        xs = np.asarray([o.slots for o in bucket.values()], np.float64)
        ys = np.asarray([o.t_round for o in bucket.values()], np.float64)
        a = np.stack([np.ones_like(xs), xs], axis=1)
        sol, *_ = np.linalg.lstsq(a, ys, rcond=None)
        c0, c1 = float(sol[0]), float(sol[1])
        return max(c0, 0.0), max(c1, 1e-12)

    def suggest(self, key: str) -> Optional[RoundPlan]:
        coeffs = self.fit(key)
        if coeffs is None:
            return None
        c0, c1 = coeffs
        with self._lock:
            bucket = dict(self._obs.get(key, {}))
        # reference observation: scale slots and emitted/round linearly in rb
        rb0, o0 = min(bucket.items(), key=lambda kv: kv[1].seconds / kv[1].samples)
        slots_per_rb = o0.slots / max(rb0, 1)
        emit_per_rb = o0.emitted_per_round / max(rb0, 1)
        best_rb, best_rate = None, -1.0
        for rb in _RB_CANDIDATES:
            slots = max(o0.slots, slots_per_rb * rb)
            emitted = max(1.0, emit_per_rb * rb)
            rate = emitted / (c0 + c1 * slots)
            if rate > best_rate:
                best_rb, best_rate = rb, rate
        assert best_rb is not None
        return RoundPlan(
            round_batch=best_rb,
            surplus_cap=8 * best_rb,
            drain_window=min(best_rb, 256),
        )


PLAN_CACHE = PlanCache()
