"""Least bytes of a round's work and of its probe kernels, from the cell's
shapes and the program's counters alone (never from how a kernel is
written), and the card's peak.

A round draws ``piece_batches[j]`` candidates for join ``j`` (the
program's own round shape).  The least a round must move, per candidate
of the piece at cover position ``k`` over a chain of ``m`` nodes:

* its uniforms: one per node and one for the piece selection (4 B each);
* per hop, the index keys at the two bounds of the hop's answer range;
* the payload columns it gathers, each output attribute once (4 B: the
  values lie in the int32 domain);
* its 128-bit fingerprint, written once (16 B);
* per earlier piece it is checked against, one 128-bit fingerprint read.

The probe kernels (B1 ``sorted_probe``, B2 ``probe_pick``; one launch per
join and hop in a round): each query read once, each result written once
(a pair of int32: the range or the pick and the degree), and each
distinct index key at a bound of an answer range read once, which is at
most two per query and at most two per distinct parent key.

A key takes 4 bytes where its packed domain fits int32, else 8.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # NVIDIA H100 SXM data sheet, at 700 W
UNIFORM_B, VALUE_B, FP_B, RESULT_B = 4, 4, 16, 8


def _key_bytes(domain: int) -> int:
    return 4 if domain < 2 ** 31 else 8


def hop_shapes(union) -> List[Dict[str, int]]:
    """Per hop of the chain: key bytes and the number of distinct keys the
    parent side can ask for."""
    out = []
    for i, node in enumerate(union.chain[1:]):
        parent = union.relations[union.chain[i].relation]
        child = union.relations[node.relation]
        dom, packed = 1, np.zeros(len(next(iter(parent.values()))), np.int64)
        for a in node.edge:
            r = int(max(parent[a].max(initial=0), child[a].max(initial=0))) + 1
            dom *= r
            packed = packed * r + parent[a]
        out.append({"key_bytes": _key_bytes(dom),
                    "parent_keys": int(np.unique(packed).size)})
    return out


def round_bytes(union, piece_batches: Sequence[int]) -> float:
    hops = hop_shapes(union)
    m = len(union.chain)
    attrs = len(union.output_attrs())
    per_hop = sum(2 * h["key_bytes"] for h in hops)
    total = 0.0
    for k, b in enumerate(piece_batches):
        per = (UNIFORM_B * (m + 1) + per_hop + VALUE_B * attrs + FP_B
               + FP_B * k)
        total += b * per
    return total


def probe_bytes(union, piece_batches: Sequence[int]) -> float:
    total = 0.0
    for h in hop_shapes(union):
        kb = h["key_bytes"]
        for b in piece_batches:
            total += b * (kb + RESULT_B) + min(2 * b, 2 * h["parent_keys"]) * kb
    return total


def probe_launches_per_round(union, piece_batches: Sequence[int]) -> int:
    return (len(union.chain) - 1) * sum(1 for b in piece_batches if b > 0)
