"""Edge cases of the port's kernels, one list for every check that uses them.

The CPU tests feed these seeded numpy inputs (and, for the probes, the pick
uniforms of :func:`probe_uniforms`) to the reference package and to the
port's plain versions; the card's tests, ``chip_smoke.py`` and
``scripts/kernel_variants.py`` feed the same inputs to the CUDA kernels and
the plain versions.  The attention tolerances live here too, so every
comparison holds the same limit.  Nothing here touches a device.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

I64_MAX = np.iinfo(np.int64).max
I64_MIN = np.iinfo(np.int64).min


I32_MAX = np.iinfo(np.int32).max
I32_MIN = np.iinfo(np.int32).min


def key_dtypes(*arrays: np.ndarray) -> List[torch.dtype]:
    """int64, and int32 wherever every value fits."""
    vals = np.concatenate([np.asarray(a, np.int64).ravel() for a in arrays])
    out = [torch.int64]
    if vals.size == 0 or (vals.min() >= I32_MIN and vals.max() <= I32_MAX):
        out.append(torch.int32)
    return out


# ---------------------------------------------------------------------------
# sorted probe and probe-and-pick: (keys, queries), keys sorted int64
# ---------------------------------------------------------------------------

# The card's search cuts a range into G + 1 parts per level with G lanes
# (G = 8, 16 or 32): n below, at and around G and (G + 1)^2 = 33^2, runs
# longer than many splitter gaps, and queries at the dtype's extremes.
PROBE_CASES = ["runs_straddle_blocks", "below_and_above", "dom_2_45",
               "single_key", "empty_keys", "runs_straddle_splitters",
               "n_1088", "n_1089", "n_1090", "extremes_i32",
               "extremes_i64"] + [f"n_{n}" for n in range(1, 41)]
# held against the plain versions on the card only (the CPU tests hold the
# cases above against the reference): 2^20 keys of about 1,000 distinct
# values, so each query's degree is about 1,000
PROBE_CARD_CASES = ["large_2_20"]
# the cases the reference's Pallas kernels take (at least two key blocks;
# not extremes_i64: walk_hop_pallas pads the keys with INT64_MAX and counts
# the pads in the degree of a query equal to INT64_MAX)
PALLAS_PROBE_CASES = ["runs_straddle_blocks", "below_and_above", "dom_2_45",
                      "runs_straddle_splitters", "n_1088", "n_1089",
                      "n_1090", "extremes_i32"]


def _small_keys(rng, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """n sorted keys with repeats; every value from below the first key to
    above the last as a query, and a few far outside."""
    keys = np.sort(rng.integers(0, max(n // 2, 1) + 2, n)) * 3 - 7
    qs = np.concatenate([np.arange(keys[0] - 2, keys[-1] + 3),
                         [-10**6, 10**6]])
    return keys, qs


def probe_case(name: str) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng((PROBE_CASES + PROBE_CARD_CASES).index(name))
    if name.startswith("n_"):
        keys, qs = _small_keys(rng, int(name[2:]))
    elif name == "runs_straddle_splitters":
        # three runs of 100,000 keys: each spans many splitter gaps of the
        # top levels, so lo and hi part at the first splitter equal to q
        keys = np.repeat(np.arange(3, dtype=np.int64), 100_000)
        qs = np.array([-1, 0, 1, 2, 3, 0, 1, 2], np.int64)
    elif name.startswith("extremes_"):
        lo, hi = ((I32_MIN, I32_MAX) if name.endswith("i32")
                  else (I64_MIN, I64_MAX))
        keys = np.concatenate([[lo, lo], np.sort(rng.integers(-1000, 1000, 97)),
                               [hi]])
        qs = np.array([lo, lo + 1, keys[2], keys[-2], hi - 1, hi, 0], np.int64)
    elif name == "runs_straddle_blocks":
        keys = np.repeat(np.arange(5, dtype=np.int64), 200)     # 1000 keys
        qs = np.arange(-1, 7, dtype=np.int64)
    elif name == "below_and_above":
        keys = np.sort(rng.integers(100, 200, 300))
        qs = np.array([-5, 0, 99, 100, 150, 199, 200, 10**6], np.int64)
    elif name == "dom_2_45":
        keys = np.sort(rng.integers(-2**45, 2**45, 700))
        qs = np.concatenate([rng.integers(-2**46, 2**46, 200), keys[::7]])
    elif name == "large_2_20":
        keys = np.sort(rng.integers(0, 1000, 1 << 20))
        qs = rng.integers(-10, 1010, 100_000)
    elif name == "single_key":
        keys = np.array([7], np.int64)
        qs = np.array([6, 7, 8], np.int64)
    else:
        keys = np.zeros(0, np.int64)
        qs = np.array([-1, 0, 5], np.int64)
    return keys.astype(np.int64), qs.astype(np.int64)


# the largest float32 below 1: u·d must stay below d after the pick's floor
ONE_MINUS = np.nextafter(np.float32(1), np.float32(0))


def probe_degrees(keys: np.ndarray, qs: np.ndarray) -> np.ndarray:
    """#keys == q per query (d = hi - lo)."""
    return (np.searchsorted(keys, qs, side="right")
            - np.searchsorted(keys, qs, side="left"))


def least_u_reaching(k: np.ndarray, d: np.ndarray) -> np.ndarray:
    """The least float32 u whose float32 product u·d is at least k, per
    element (0 where k is 0)."""
    k = np.asarray(k, np.int64)
    d32 = np.asarray(d, np.float32)
    u = (k / np.maximum(d32, 1)).astype(np.float32)
    while True:                                     # up to the first u ...
        low = u * d32 < k
        if not low.any():
            break
        u[low] = np.nextafter(u[low], np.float32(1))
    while True:                                     # ... then to the least
        prev = np.nextafter(u, np.float32(0))
        ok = (k > 0) & (prev * d32 >= k)
        if not ok.any():
            return u
        u[ok] = prev[ok]


def landing_uniforms(rng: np.random.Generator, d: np.ndarray) -> np.ndarray:
    """Per degree d, a float32 u whose float32 product u·d is an integer k
    in [0, d), with u the least such for its k.  Of 16 random tries of k it
    keeps, where it finds one, a k whose exact product u·d lies below k (so
    floor of the unrounded product gives k - 1), else a k > 0; u is 0
    (k = 0) where no try lands, d < 2 among them."""
    d = np.asarray(d, np.int64)
    d32 = d.astype(np.float32)
    out = np.zeros(d.shape[0], np.float32)
    best = np.zeros(d.shape[0], np.int64)
    for _ in range(16):
        k = np.floor(rng.random(d.shape[0]) * d).astype(np.int64)
        u = least_u_reaching(k, d)
        lands = (u * d32 == k) & (k > 0)
        score = lands * (1 + (u.astype(np.float64) * d < k))
        take = score > best
        out[take] = u[take]
        best[take] = score[take]
    return out


def probe_uniforms(name: str, nq: int) -> np.ndarray:
    """Seeded float32 pick uniforms in [0, 1) for the ``nq`` queries of
    probe case ``name``.  Of every five queries one gets 0, one 1⁻
    (:data:`ONE_MINUS`), and one a u whose float32 product with the query's
    degree lands on an integer (:func:`landing_uniforms`); the other two
    are random."""
    keys, qs = probe_case(name)
    if qs.shape[0] != nq:
        raise ValueError(f"probe case {name} has {qs.shape[0]} queries, "
                         f"not {nq}")
    rng = np.random.default_rng(
        1000 + (PROBE_CASES + PROBE_CARD_CASES).index(name))
    u = rng.random(nq, dtype=np.float32)
    u[0::5] = 0
    u[1::5] = ONE_MINUS
    u[2::5] = landing_uniforms(rng, probe_degrees(keys, qs[2::5]))
    return u


# ---------------------------------------------------------------------------
# segdegree: a sorted int64 key column
# ---------------------------------------------------------------------------

SEGDEGREE_CASES = [f"sweep_{i}" for i in range(12)] + [
    "run_spanning_many_blocks", "empty", "single", "negative", "int64_max",
    "int64_min", "all_distinct", "tile_aligned_runs", "runs_straddle_tiles"]
# millions of keys, and the edges of the card's kernel: views whose first
# key is not 16-byte aligned, columns shorter than one 16-byte vector, runs
# that end on a CTA's (or a warp's) range boundary or one key past it, and
# one run across every CTA's range
SEGDEGREE_CARD_CASES = ["multi_level_merge", "run_across_every_tile",
                        "view_offset_1", "view_offset_2", "view_offset_3",
                        "short_1", "short_2", "short_3",
                        "run_ends_on_cta_boundary",
                        "run_ends_past_cta_boundary",
                        "run_ends_on_warp_boundary", "run_across_every_cta"]
# the card's kernel cuts a call into CTAs of cta_keys keys and each CTA
# into this many warps
SEGDEGREE_WARPS = 8
SEGDEGREE_BOUNDARY_KEYS = 3_000_000


def segdegree_card_case(name: str, cta_keys) -> Tuple[np.ndarray, int]:
    """``(base, offset)`` for any segdegree case: the column is
    ``base[offset:]`` (a view when offset > 0).  ``cta_keys(n)`` gives the keys of each CTA's range in a
    call of n keys, as the card's kernel cuts it."""
    if name in SEGDEGREE_CASES or name in ("multi_level_merge",
                                           "run_across_every_tile"):
        return segdegree_keys(name), 0
    rng = np.random.default_rng(SEGDEGREE_CARD_CASES.index(name) + 100)
    if name.startswith("view_offset_"):
        off = int(name[-1])
        base = np.sort(rng.integers(0, 5000, 100_003 + off))
        return base.astype(np.int64), off
    if name.startswith("short_"):
        n = int(name[-1])
        return np.sort(rng.integers(0, 2, n + 1)).astype(np.int64), 1
    n = SEGDEGREE_BOUNDARY_KEYS
    k = int(cta_keys(n))
    i = np.arange(n, dtype=np.int64)
    if name == "run_ends_on_cta_boundary":
        keys = i // k                       # run c is CTA c's range
    elif name == "run_ends_past_cta_boundary":
        keys = (i + k - 1) // k             # each run ends one key past
    elif name == "run_ends_on_warp_boundary":
        keys = i // max(k // SEGDEGREE_WARPS, 1)
    else:                                   # run_across_every_cta
        keys = np.concatenate([np.zeros(n - 60, np.int64),
                               np.repeat(np.arange(1, 21), 3)])
    return keys, 0


def segdegree_keys(name: str) -> np.ndarray:
    """The sweeps are drawn like the reference's ``test_segdegree_sweep``
    (n in [1, 4000], keys in [0, dom))."""
    if name.startswith("sweep_"):
        rng = np.random.default_rng(int(name[6:]))
        n, dom = int(rng.integers(1, 4001)), int(rng.integers(1, 201))
        return np.sort(rng.integers(0, dom, n)).astype(np.int64)
    rng = np.random.default_rng((SEGDEGREE_CASES + SEGDEGREE_CARD_CASES)
                                .index(name))
    keys = {
        "run_spanning_many_blocks": lambda: np.full(1000, 42),
        "empty": lambda: np.zeros(0),
        "single": lambda: np.array([7]),
        "negative": lambda: np.sort(rng.integers(-500, 500, 3001)),
        # a real key equal to the reference's padding value
        "int64_max": lambda: np.concatenate(
            [np.sort(rng.integers(0, 2**62, 300)), np.full(5, I64_MAX)]),
        "int64_min": lambda: np.concatenate(
            [np.full(3, I64_MIN), np.sort(rng.integers(-2**40, 2**40, 400))]),
        "all_distinct": lambda: np.arange(-2500, 2500),
        "tile_aligned_runs": lambda: np.repeat(np.arange(4), 2048),
        "runs_straddle_tiles": lambda: np.repeat(np.arange(7), 1999),
        "multi_level_merge": lambda: np.repeat(
            np.arange(1_250_000), rng.integers(1, 8, 1_250_000)),
        # one run of 2048^2 + 1 keys across many CTA ranges, then short runs
        "run_across_every_tile": lambda: np.repeat(
            np.arange(3), [2048 * 2048 + 1, 5, 2048 * 3]),
    }[name]()
    return np.asarray(keys, np.int64)


# ---------------------------------------------------------------------------
# decode attention
# ---------------------------------------------------------------------------

# f32: the kernel and the plain version differ only in summation order
F32_TOL = 2e-5
# bf16 output, compared in fp32: rounding to bf16 moves a value by at most
# half an ulp (2^-8 of it), and two roundings differ by at most one ulp
# (2^-7 < 1e-2); atol covers outputs near 0
BF16_RTOL, BF16_ATOL = 1e-2, 1e-3


def attention_tol(dtype: torch.dtype) -> Dict[str, float]:
    """``rtol``/``atol`` for an output of ``dtype`` against fp32."""
    if dtype == torch.bfloat16:
        return {"rtol": BF16_RTOL, "atol": BF16_ATOL}
    return {"rtol": F32_TOL, "atol": F32_TOL}


# (B, H, KVH, D, S, softcap, window): the shapes of the reference's
# tests/test_kernels.py
ATTENTION_SHAPES = [
    (2, 8, 4, 128, 384, 0.0, 0),
    (1, 16, 8, 128, 256, 50.0, 0),
    (2, 4, 1, 128, 512, 0.0, 128),
    (1, 8, 8, 64, 256, 30.0, 64),
    (3, 4, 2, 64, 130, 0.0, 0),     # S not a multiple of 128
]
ATTENTION_CASES = [f"shape_{i}" for i in range(len(ATTENTION_SHAPES))] + [
    "bf16", "length_0", "shorter_than_window", "head_mapping",
    "softcap_range", "softcap_range_bf16", "skewed_lengths", "many_pairs",
    "all_zero_lengths"]


def config_attention_shapes() -> List[Tuple[int, int, int]]:
    """(H, KVH, D) of every config with attention and of its smoke config
    (:mod:`repro_torch.configs`), sorted: every shape the LM path can give
    decode attention."""
    from ..configs import ASSIGNED_ARCHS, get_config, get_smoke_config
    shapes = {(c.n_heads, c.n_kv_heads, c.head_dim)
              for a in ASSIGNED_ARCHS + ["unionlm-100m"]
              for c in (get_config(a), get_smoke_config(a)) if c.n_heads > 0}
    return sorted(shapes)


# each config shape twice, in f32 (window 0, softcap 0) and in bf16 (window
# 48, softcap 30); query heads mapped to their KV head at G 12 and G 48,
# where a KV head's heads are cut into several work items of the card's
# kernel; and many (b, kv head) pairs at G 48
ATTENTION_CONFIG_CASES = [
    f"config_{h}_{kv}_{d}{sfx}" for h, kv, d in config_attention_shapes()
    for sfx in ("", "_bf16")] + [
    "head_mapping_g12", "head_mapping_g48", "many_pairs_g48"]
ATTENTION_CASES += ATTENTION_CONFIG_CASES


def attention_inputs(B: int, H: int, KVH: int, D: int, S: int, seed: int):
    """float32 q, k, v and lengths in [S // 2, S], drawn as the reference's
    tests draw them."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    lens = rng.integers(max(S // 2, 1), S + 1, B)
    return q, k, v, lens


def attention_case(name: str) -> dict:
    """``{"q", "k", "v", "lens", "softcap", "window", "dtype"}`` with float32
    numpy inputs (cast to ``dtype`` before the call); ``head_mapping`` adds
    ``heads``, the value each query head must return."""
    c = {"softcap": 0.0, "window": 0, "dtype": torch.float32}
    if name.startswith("shape_"):
        B, H, KVH, D, S, c["softcap"], c["window"] = ATTENTION_SHAPES[
            int(name[6:])]
        q, k, v, lens = attention_inputs(B, H, KVH, D, S, B * 1000 + S)
    elif name == "bf16":
        q, k, v, lens = attention_inputs(2, 8, 4, 128, 256, 5)
        lens[:] = 256
        c["dtype"] = torch.bfloat16
    elif name == "length_0":
        q, k, v, lens = attention_inputs(2, 8, 2, 128, 200, 11)
        lens[0] = 0
    elif name == "shorter_than_window":
        q, k, v, lens = attention_inputs(2, 4, 2, 256, 300, 12)
        lens[:] = [5, 40]
        c["window"] = 64
    elif name.startswith("config_"):
        H, KVH, D = (int(x) for x in name.split("_")[1:4])
        q, k, v, lens = attention_inputs(3, H, KVH, D, 200, H * 1000 + D)
        if name.endswith("_bf16"):
            c.update(dtype=torch.bfloat16, window=48, softcap=30.0)
    elif name == "many_pairs_g48":
        q, k, v, lens = attention_inputs(40, 96, 2, 128, 40, 17)
    elif name.startswith("head_mapping"):
        # KV head j's values are all j + 1, so query head h must return
        # h // G + 1 (not h % KVH + 1)
        B, H, KVH, D, S = {"head_mapping": (1, 8, 4, 64, 40),
                           "head_mapping_g12": (2, 36, 3, 112, 40),
                           "head_mapping_g48": (2, 96, 2, 16, 40)}[name]
        rng = np.random.default_rng(7)
        q = rng.standard_normal((B, H, D)).astype(np.float32)
        k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
        v = np.broadcast_to(np.arange(1, KVH + 1, dtype=np.float32)
                            [None, None, :, None], (B, S, KVH, D)).copy()
        lens = np.full(B, S)
        c["heads"] = np.repeat(np.arange(1, KVH + 1), H // KVH)
    elif name.startswith("softcap_range"):
        # logits of std softcap / 2, where tanh bends them: a kernel that
        # dropped the softcap fails the tolerance here
        q, k, v, lens = attention_inputs(2, 8, 4, 128, 384, 13)
        c["softcap"] = 50.0
        q *= c["softcap"] / 2
        if name.endswith("_bf16"):
            c["dtype"] = torch.bfloat16
    elif name == "skewed_lengths":
        # one row at S, the others at 0-3 rows: the card's plan gives the long
        # pair many CTAs and packs the short ones into one
        q, k, v, lens = attention_inputs(6, 8, 4, 128, 1000, 14)
        lens[:] = [1000, 0, 1, 2, 3, 1]
    elif name == "many_pairs":
        # B * KVH = 288 pairs of 20-40 rows, more than an H100's 264 CTAs:
        # CTAs of the card's kernel span several pairs
        q, k, v, lens = attention_inputs(36, 16, 8, 64, 40, 15)
    elif name == "all_zero_lengths":
        q, k, v, lens = attention_inputs(3, 4, 2, 64, 64, 16)
        lens[:] = 0
    else:
        raise KeyError(name)
    c.update(q=q, k=k, v=v, lens=lens)
    return c


# ---------------------------------------------------------------------------
# decode steps through B4 against the same steps through the plain version
# ---------------------------------------------------------------------------

# bf16 logits of the same decode_step sequence (same parameters, the same
# tokens at every step) with decode attention through the kernel and
# through decode_attention_plain: the two differ only in the attention's
# summation order, rounded to bf16 (at most one ulp an element), which the
# layers carry to the logits.  Calibrated before any card run on the CPU,
# on random 32- and 42-layer bf16 models whose attention outputs were given
# one-ulp flips: at most 2.4-3.5 % of the largest logit, correlation >=
# 0.9997, greedy agreement 0.94-0.96.  The limits leave room for the full
# widths: correlation > 0.999, the largest difference at most 10 % of the
# largest logit, and greedy (argmax) agreement >= 0.5, as the reference's
# decode-against-prefill bar.
LM_PATH_CORR, LM_PATH_REL, LM_PATH_AGREE = 0.999, 0.10, 0.5


def lm_logits_agreement(got: torch.Tensor, want: torch.Tensor,
                        what: str = "logits") -> Dict[str, float]:
    """``{"corr", "rel", "agree"}`` of two (steps, B, vocab) stacks of
    float32 logits, each step held to the ``LM_PATH_*`` limits (raises
    ``AssertionError`` naming the step)."""
    out = {"corr": 1.0, "rel": 0.0, "agree": 0.0}
    agree = []
    for t, (g, w) in enumerate(zip(got.double(), want.double())):
        corr = float(torch.corrcoef(torch.stack([g.ravel(), w.ravel()]))[0, 1])
        rel = float((g - w).abs().max() / w.abs().max())
        if not (corr > LM_PATH_CORR and rel <= LM_PATH_REL):
            raise AssertionError(f"{what} step {t}: correlation {corr}, "
                                 f"largest difference {rel} of the largest "
                                 f"logit (limits > {LM_PATH_CORR}, <= "
                                 f"{LM_PATH_REL})")
        out["corr"] = min(out["corr"], corr)
        out["rel"] = max(out["rel"], rel)
        agree.append((g.argmax(-1) == w.argmax(-1)).double())
    out["agree"] = float(torch.cat(agree).mean())
    if out["agree"] < LM_PATH_AGREE:
        raise AssertionError(f"{what}: greedy agreement {out['agree']} < "
                             f"{LM_PATH_AGREE}")
    return out


# ---------------------------------------------------------------------------
# earlier-piece membership lookup: candidates, pieces, live and predicate
# masks
# ---------------------------------------------------------------------------

# (relation widths, whether consecutive relations share an attribute,
# pieces, candidates, live share; None: no live mask).  "q5" and "uq1" have
# the attribute counts of Q5's and UQ1's base relations and their earlier
# pieces at the last probing join; "many_pairs" has 60 (piece, relation)
# pairs, more than a warp's lanes, so a lane takes two; "past_pairs" (70
# pairs) and "past_pieces" (18 pieces) pass one launch's capacities, so the
# card runs them in two launches; "dup_window" plants salt-1 collisions
# with other salt-2 fingerprints in a run of duplicate rows.
_MEMBER_SHAPES = {
    "q5": ((4, 8, 9, 16, 7, 2), True, 2, 4096, 0.05),
    "uq1": ((4, 7, 8, 9, 16), True, 4, 4096, 0.9),
    "one_piece": ((4, 7, 8, 9, 16), True, 1, 1000, None),
    "dup_window": ((2, 3), False, 2, 777, 0.8),
    "empty_relation": ((4, 7, 8), True, 3, 500, 0.8),
    "all_dead": ((4, 8, 9, 16, 7, 2), True, 2, 1024, 0.0),
    "all_live": ((4, 8, 9, 16, 7, 2), True, 2, 1024, 1.0),
    "predicate": ((4, 7, 8, 9, 16), True, 3, 2048, 0.7),
    "many_pairs": ((4, 7, 8, 9, 16), True, 12, 1500, 0.9),
    "past_pairs": ((4, 7, 8, 9, 16), True, 14, 1500, 0.9),
    "past_pieces": ((3, 5), True, 18, 1000, 0.9),
}
# the runs of pieces, one launch each, of the cases past one launch
MEMBER_LAUNCHES = {"past_pairs": [(0, 12), (12, 14)],
                   "past_pieces": [(0, 16), (16, 18)]}
MEMBER_CASES = list(_MEMBER_SHAPES)

_M32 = 0xFFFFFFFF
_FNV = 16777619


def _mix32_py(x: int, salt: int) -> int:
    z = (x + 0x9E3779B9 * (salt + 1)) & _M32
    z = ((z ^ (z >> 16)) * 0x85EBCA6B) & _M32
    z = ((z ^ (z >> 13)) * 0xC2B2AE35) & _M32
    return z ^ (z >> 16)


def _unmix32_py(z: int, salt: int) -> int:
    z ^= z >> 16
    z = (z * pow(0xC2B2AE35, -1, 1 << 32)) & _M32
    z ^= (z >> 13) ^ (z >> 26)
    z = (z * pow(0x85EBCA6B, -1, 1 << 32)) & _M32
    z ^= z >> 16
    return (z - 0x9E3779B9 * (salt + 1)) & _M32


def _fp1_collision(rng, row: np.ndarray) -> np.ndarray:
    """Another 2-column row with the salt-1 fingerprint of ``row``."""
    f = ((_mix32_py(int(row[0]), 1000) * _FNV) & _M32) ^ _mix32_py(
        int(row[1]), 1001)
    while True:
        v0 = int(rng.integers(0, 1 << 31))
        v1 = _unmix32_py(f ^ ((_mix32_py(v0, 1000) * _FNV) & _M32), 1001)
        if v0 != row[0] and v1 < (1 << 31):
            return np.array([v0, v1], np.int64)


def member_case(name: str) -> dict:
    """``{"rows": {attr: (B,) int32}, "acc": (B,) bool or None, "pieces":
    [[(attrs, (n, len(attrs)) int32), ...] per piece], "preds": [(B,) bool
    or None per piece]}``.  Each piece's relations are projections of a
    join of its own (tuples shared in part with the other pieces), plus
    rows of no tuple and repeated rows; candidates copy tuples of each
    piece, of none, and tuples with one attribute moved."""
    widths, shared, npieces, B, live = _MEMBER_SHAPES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    spans, start = [], 0
    for w in widths:
        spans.append(list(range(start, start + w)))
        start += w - 1 if shared else w
    nattr = start + (1 if shared else 0)
    attrs = [f"c{i:02d}" for i in range(nattr)]
    common = rng.integers(0, 1 << 31, (120, nattr))
    tuples = [np.concatenate([common, rng.integers(0, 1 << 31,
                                                   (180, nattr))])
              for _ in range(npieces)]
    pieces = []
    for q, tq in enumerate(tuples):
        rels = []
        for r, span in enumerate(spans):
            rows = np.concatenate([tq[:, span],
                                   rng.integers(0, 1 << 31, (40, len(span))),
                                   tq[:5, span], tq[:3, span]])
            if name == "dup_window" and r == 0:
                rows = np.concatenate([rows] + [
                    _fp1_collision(rng, rows[0])[None]] * 2)
            if name == "empty_relation" and q == 1 and r == 2:
                rows = rows[:0]
            rels.append((tuple(attrs[i] for i in span),
                         rows.astype(np.int32)))
        pieces.append(rels)
    kind = rng.integers(0, npieces + 2, B)
    cand = rng.integers(0, 1 << 31, (B, nattr))
    for q, tq in enumerate(tuples):
        sel = kind == q
        cand[sel] = tq[rng.integers(0, tq.shape[0], int(sel.sum()))]
    moved = kind == npieces + 1
    src = tuples[0][rng.integers(0, tuples[0].shape[0], int(moved.sum()))]
    src[np.arange(src.shape[0]), rng.integers(0, nattr, src.shape[0])] += 1
    cand[moved] = src
    if name == "dup_window":
        # salt-1 twins of a member row: one in the relation, one not
        x = pieces[0][0][1][0]
        cand[:20, spans[0]] = pieces[0][0][1][-1]
        cand[20:40, spans[0]] = _fp1_collision(rng, x)
    acc = None if live is None else rng.random(B) < live
    preds = [None] * npieces
    if name == "predicate":
        preds = [rng.random(B) < 0.5 if q != 1 else None
                 for q in range(npieces)]
    return {"rows": {a: cand[:, i].astype(np.int32)
                     for i, a in enumerate(attrs)},
            "acc": acc, "pieces": pieces, "preds": preds}


def member_plan(case: dict, device) -> Tuple[object, Dict[str, torch.Tensor],
                                             object, List[object]]:
    """``(plan, rows, acc, preds)`` of a :func:`member_case` on ``device``."""
    from .member import MemberPlan, relation_index
    plan = MemberPlan([
        [relation_index(a, [np.ascontiguousarray(rows[:, i])
                            for i in range(len(a))], device)
         for a, rows in piece]
        for piece in case["pieces"]])
    rows = {a: torch.as_tensor(c, device=device)
            for a, c in case["rows"].items()}
    acc = (None if case["acc"] is None
           else torch.as_tensor(case["acc"], device=device))
    preds = [None if m is None else torch.as_tensor(m, device=device)
             for m in case["preds"]]
    return plan, rows, acc, preds
