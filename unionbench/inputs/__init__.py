"""The benchmark's inputs: a union of joins over TPC-H data.

A configuration names a builder (``"workload": "uq1"`` is
``unionbench/inputs/uq1.py``) that makes, from the run's seed, one
:class:`Union`: the base relations as plain numpy columns, and per join
its nodes, the rows its variant keeps and its §8.3 pushdown predicates.
The same object goes to the program (through its public constructors,
:mod:`unionbench.program`) and to the reference named by the configuration
(:mod:`unionbench.reference`), so both read the same arrays.

A join is a tree of nodes over the union's relations, root first, with
optional §8.2 residual nodes that close cycles.  A join that names no
nodes of its own follows the union's ``chain``, each node joined to the
node before: the chains of UQ1 and UQ2.  A relation appears at most once
in a join; a node is named by its relation.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Columns = Dict[str, np.ndarray]
Pred = Tuple[str, str, object]          # (attribute, "<=" | ">=" | "in" | ..., value)


@dataclasses.dataclass
class Node:
    relation: str                       # base relation name, the node's name
    edge: Tuple[str, ...]               # attributes shared with the parent
    # a tree node's parent (None: the node before); the root and residual
    # nodes have none (a residual's edge attributes may come from several
    # earlier nodes)
    parent: Optional[str] = None
    kind: str = "tree"                  # "tree" | "residual"


@dataclasses.dataclass
class Join:
    name: str
    masks: Dict[str, np.ndarray]        # rows of a base relation this join keeps
    preds: List[Pred]                   # pushdown predicates (filters at build)
    nodes: Optional[List[Node]] = None  # None: the union's chain


@dataclasses.dataclass
class Union:
    relations: Dict[str, Columns]       # base relations, columns as joined
    keys: Dict[str, Tuple[str, ...]]    # primary key of each relation
    chain: List[Node]                   # root first; joins without nodes
    joins: List[Join]                   # cover order

    def nodes(self, k: int) -> List[Node]:
        """Join ``k``'s nodes in order, each tree node's parent named (the
        root's and a residual node's is None)."""
        j = self.joins[k]
        raw = self.chain if j.nodes is None else j.nodes
        out: List[Node] = []
        for i, n in enumerate(raw):
            if n.kind not in ("tree", "residual"):
                raise ValueError(f"join {j.name!r}: node {n.relation!r} has "
                                 f"kind {n.kind!r}")
            if n.relation not in self.relations:
                raise ValueError(f"join {j.name!r}: no relation {n.relation!r}")
            if n.relation in (m.relation for m in out):
                raise ValueError(f"join {j.name!r}: relation {n.relation!r} "
                                 "appears twice")
            parent = None
            if i and n.kind == "tree":
                parent = raw[i - 1].relation if n.parent is None else n.parent
                if parent not in (m.relation for m in out):
                    raise ValueError(f"join {j.name!r}: node {n.relation!r} "
                                     f"names no earlier parent ({parent!r})")
            elif i == 0 and n.kind != "tree":
                raise ValueError(f"join {j.name!r}: the root must be a tree node")
            out.append(Node(n.relation, tuple(n.edge), parent, n.kind))
        return out

    def is_chain(self, k: int) -> bool:
        """Whether join ``k``'s nodes form a chain: tree nodes only, each
        joined to the node before."""
        nodes = self.nodes(k)
        before = [None] + [n.relation for n in nodes[:-1]]
        return all(n.kind == "tree" and n.parent == b
                   for n, b in zip(nodes, before))

    def output_attrs(self) -> List[str]:
        """The output schema every join shares, in the first join's node
        order."""
        seen: List[str] = []
        for node in self.nodes(0):
            for a in self.relations[node.relation]:
                if a not in seen:
                    seen.append(a)
        return seen


def config_preds(entries: Sequence) -> List[Pred]:
    """Predicates as a configuration writes them: ``[attr, op, value]``,
    an ``in`` value as a list."""
    out = []
    for attr, op, value in entries:
        out.append((str(attr), str(op),
                    frozenset(int(v) for v in value) if op == "in" else value))
    return out


def build(config: dict, seed: int) -> Union:
    """The union that ``config`` describes, made from ``seed``."""
    module = importlib.import_module(f"unionbench.inputs.{config['workload']}")
    return module.build(config, int(seed))
