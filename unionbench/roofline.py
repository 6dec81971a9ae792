"""Least bytes of a round's work and of its probe kernels, from the cell's
shapes and the program's counters alone (never from how a kernel is
written), and the card's peak.

A round draws ``piece_batches[k]`` candidates for the join at cover
position ``k`` (the program's own round shape).  The least a round must
move, per candidate of that piece, over the ``m`` nodes of its own join:

* its uniforms: one per node, one for a cyclic join's ``Π d/M``
  acceptance test, and one for the piece selection (4 B each);
* per hop, the index keys at the two bounds of the hop's answer range;
* the payload columns it gathers, each output attribute once (4 B: the
  values lie in the int32 domain);
* its 128-bit fingerprint, written once (16 B);
* per earlier piece it is checked against, one 128-bit fingerprint read.

A join has one hop per node but its root: a tree node's against its
parent, a §8.2 residual node's against the earlier nodes that hold its
edge attributes.  The probe kernels (B1 ``sorted_probe``, B2
``probe_pick``; one launch per join and hop in a round): each query read
once, each result written once (a pair of int32: the range or the pick and
the degree), and each distinct index key at a bound of an answer range
read once, which is at most two per query and at most two per distinct
key the parent side can ask for (a residual hop: per distinct key of its
own index, at whose key boundaries every answer range lies).

A key takes 4 bytes where its packed domain fits int32, else 8.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # NVIDIA H100 SXM data sheet, at 700 W
UNIFORM_B, VALUE_B, FP_B, RESULT_B = 4, 4, 16, 8


def _key_bytes(domain: int) -> int:
    return 4 if domain < 2 ** 31 else 8


def hop_shapes(union, k: int = 0) -> List[Dict[str, int]]:
    """Per hop of join ``k``: key bytes and the number of distinct keys the
    parent side can ask for."""
    nodes = union.nodes(k)
    out = []
    for node in nodes[1:]:
        child = union.relations[node.relation]
        if node.kind == "residual":
            # each edge attribute from the first tree node that holds it
            sides = [union.relations[next(
                n.relation for n in nodes
                if n.kind == "tree" and a in union.relations[n.relation])]
                for a in node.edge]
            asker = child
        else:
            parent = union.relations[node.parent]
            sides, asker = [parent] * len(node.edge), parent
        dom = 1
        packed = np.zeros(len(next(iter(asker.values()))), np.int64)
        for a, side in zip(node.edge, sides):
            r = int(max(side[a].max(initial=0), child[a].max(initial=0))) + 1
            dom *= r
            packed = packed * r + asker[a]
        out.append({"key_bytes": _key_bytes(dom),
                    "parent_keys": int(np.unique(packed).size)})
    return out


def _hops_per_join(union, joins: int) -> List[List[Dict[str, int]]]:
    """``hop_shapes`` of the first ``joins`` joins, worked out once per
    distinct node list."""
    seen: Dict[tuple, List[Dict[str, int]]] = {}
    out = []
    for k in range(joins):
        key = tuple(dataclasses.astuple(n) for n in union.nodes(k))
        if key not in seen:
            seen[key] = hop_shapes(union, k)
        out.append(seen[key])
    return out


def round_bytes(union, piece_batches: Sequence[int]) -> float:
    attrs = len(union.output_attrs())
    hops = _hops_per_join(union, len(piece_batches))
    total = 0.0
    for k, b in enumerate(piece_batches):
        nodes = union.nodes(k)
        uniforms = len(nodes) + 1 + any(n.kind == "residual" for n in nodes)
        per_hop = sum(2 * h["key_bytes"] for h in hops[k])
        per = (UNIFORM_B * uniforms + per_hop + VALUE_B * attrs + FP_B
               + FP_B * k)
        total += b * per
    return total


def probe_bytes(union, piece_batches: Sequence[int]) -> float:
    hops = _hops_per_join(union, len(piece_batches))
    total = 0.0
    for k, b in enumerate(piece_batches):
        for h in hops[k]:
            kb = h["key_bytes"]
            total += b * (kb + RESULT_B) + min(2 * b, 2 * h["parent_keys"]) * kb
    return total


def probe_launches_per_round(union, piece_batches: Sequence[int]) -> int:
    return sum(len(union.nodes(k)) - 1
               for k, b in enumerate(piece_batches) if b > 0)
