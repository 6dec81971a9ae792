"""The benchmark's inputs: a union of chain joins over TPC-H data.

A configuration names a builder (``"workload": "uq1"`` is
``unionbench/inputs/uq1.py``) that makes, from the run's seed, one
:class:`Union`: the base relations as plain numpy columns, the chain every
join follows, and per join the rows its variant keeps and its §8.3
pushdown predicates.  The same object goes to the program (through its
public constructors, :mod:`unionbench.program`) and to the reference
(:mod:`unionbench.reference`), so both read the same arrays.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

Columns = Dict[str, np.ndarray]
Pred = Tuple[str, str, object]          # (attribute, "<=" | ">=" | "in" | ..., value)


@dataclasses.dataclass
class Node:
    relation: str                       # base relation name
    edge: Tuple[str, ...]               # attributes shared with the node before


@dataclasses.dataclass
class Join:
    name: str
    masks: Dict[str, np.ndarray]        # rows of a base relation this join keeps
    preds: List[Pred]                   # pushdown predicates (filters at build)


@dataclasses.dataclass
class Union:
    relations: Dict[str, Columns]       # base relations, columns as joined
    keys: Dict[str, Tuple[str, ...]]    # primary key of each relation
    chain: List[Node]                   # root first
    joins: List[Join]                   # cover order

    def output_attrs(self) -> List[str]:
        seen: List[str] = []
        for node in self.chain:
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
