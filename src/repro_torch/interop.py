"""Carry a workload's state into the port from plain numpy arrays.

The reference's "weights" are its data and state: relation columns, join
specs and the cover.  :func:`workload_from_numpy` builds the port's
:class:`Catalog`, :class:`JoinSpec` list and :class:`Cover` from plain
numpy arrays and tuples, so a test can feed both packages the same state
without the port importing the reference.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

from .core.cover import Cover
from .core.index import Catalog
from .core.joins import JoinNode, JoinSpec
from .core.relation import Relation

# one join node: (alias, relation name, parent alias or None, edge attrs, kind)
NodeTuple = Tuple[str, str, Optional[str], Sequence[str], str]


def workload_from_numpy(relations: Mapping[str, Mapping[str, np.ndarray]],
                        joins: Sequence[Tuple[str, Sequence[NodeTuple]]],
                        cover_order: Sequence[str],
                        cover_sizes: Mapping[str, float],
                        join_sizes: Optional[Mapping[str, float]] = None
                        ) -> Tuple[Catalog, List[JoinSpec], Cover]:
    """``relations``: name → {attr: column}; ``joins``: (join name, nodes)
    in union order; ``cover_order``/``cover_sizes``: the cover's join order
    and piece sizes |J'_i| (``join_sizes`` |J_i| default to the piece
    sizes).  Relations are shared by name across joins."""
    rels: Dict[str, Relation] = {
        name: Relation(name, {a: np.asarray(c) for a, c in cols.items()})
        for name, cols in relations.items()}
    cat = Catalog()
    specs = [JoinSpec(jname, [JoinNode(alias, rels[rel], parent,
                                       tuple(edge), kind)
                              for alias, rel, parent, edge, kind in nodes])
             for jname, nodes in joins]
    order = list(cover_order)
    pieces = {n: float(cover_sizes[n]) for n in order}
    sizes = pieces if join_sizes is None else {n: float(join_sizes[n])
                                                for n in order}
    return cat, specs, Cover(order, pieces, sizes)
