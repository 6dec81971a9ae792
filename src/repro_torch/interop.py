"""Carry a workload's state into the port from plain numpy arrays.

The reference's "weights" are its data and state: relation columns, join
specs and the cover.  :func:`workload_from_numpy` builds the port's
:class:`Catalog`, :class:`JoinSpec` list and :class:`Cover` from plain
numpy arrays and tuples, so a test can feed both packages the same state
without the port importing the reference.  §8.3 predicates travel as plain
``(attr, op, value)`` tuples, and a pushdown's unfiltered base join as a
join tuple over the base relations.

A model's weights travel the same way: :func:`params_from_numpy` takes the
reference's parameter dict (name → numpy array, the names of
``param_entries``) and returns the port's; :func:`train_state_from_numpy`
carries a whole train state (step, float32 masters, optimizer slots and
the error-feedback residuals).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .core.cover import Cover
from .core.index import Catalog
from .core.joins import JoinNode, JoinSpec
from .core.predicates import Pred
from .core.relation import Relation
from .device import resolve_device
from .models.transformer import param_dtype, param_entries

# one join node: (alias, relation name, parent alias or None, edge attrs, kind)
NodeTuple = Tuple[str, str, Optional[str], Sequence[str], str]
# one predicate: (attr, op, value)
PredTuple = Tuple[str, str, Any]


def workload_from_numpy(relations: Mapping[str, Mapping[str, np.ndarray]],
                        joins: Sequence[Tuple[str, Sequence[NodeTuple]]],
                        cover_order: Sequence[str],
                        cover_sizes: Mapping[str, float],
                        join_sizes: Optional[Mapping[str, float]] = None
                        ) -> Tuple[Catalog, List[JoinSpec], Cover]:
    """``relations``: name → {attr: column}; ``joins``: (join name, nodes)
    or (join name, nodes, predicates) in union order, where predicates maps
    ``pushed_preds`` and ``reject_preds`` to lists of :data:`PredTuple` and
    ``pushdown_base`` to a (join name, nodes) tuple over the unfiltered
    relations; ``cover_order``/``cover_sizes``: the cover's join order and
    piece sizes |J'_i| (``join_sizes`` |J_i| default to the piece sizes).
    Relations are shared by name across joins (a filtered relation keeps
    the name ``pushdown`` gave it)."""
    rels: Dict[str, Relation] = {
        name: Relation(name, {a: np.asarray(c) for a, c in cols.items()})
        for name, cols in relations.items()}
    cat = Catalog()
    bases: Dict[str, JoinSpec] = {}

    def spec_of(jname, nodes):
        return JoinSpec(jname, [JoinNode(alias, rels[rel], parent,
                                         tuple(edge), kind)
                                for alias, rel, parent, edge, kind in nodes])

    specs = []
    for j in joins:
        spec = spec_of(j[0], j[1])
        preds = j[2] if len(j) > 2 else {}
        if preds.get("pushdown_base") is not None:
            bname, bnodes = preds["pushdown_base"]
            if bname not in bases:             # flavours share one base spec
                bases[bname] = spec_of(bname, bnodes)
            spec.pushdown_base = bases[bname]
        for k in ("pushed_preds", "reject_preds"):
            if preds.get(k):
                setattr(spec, k, tuple(Pred(*p) for p in preds[k]))
        specs.append(spec)
    order = list(cover_order)
    pieces = {n: float(cover_sizes[n]) for n in order}
    sizes = pieces if join_sizes is None else {n: float(join_sizes[n])
                                                for n in order}
    return cat, specs, Cover(order, pieces, sizes)


def params_from_numpy(cfg, params: Mapping[str, np.ndarray], device=None,
                      dtype=None) -> Dict[str, torch.Tensor]:
    """The port's parameters (``repro_torch.models``) from the reference's
    dict of numpy arrays, on ``device`` (``None``: the card).  Every name
    and shape of ``param_entries(cfg)`` must be there.  The weights are
    stored in ``dtype`` (default ``cfg.compute_dtype``), every other
    parameter (norms, gates) in float32: the reference casts each weight to
    the activations' dtype at every use and each norm scale to float32, so
    with the default these are exactly the values it computes with."""
    dev = resolve_device(device)
    out = {}
    for name, (shape, _) in param_entries(cfg).items():
        arr = np.asarray(params[name])
        if arr.shape != tuple(shape):
            raise ValueError(f"params_from_numpy: {name} has shape "
                             f"{arr.shape}, the config needs {tuple(shape)}")
        dt = param_dtype(cfg, name, shape)
        if dtype is not None and dt != torch.float32:
            dt = dtype
        out[name] = torch.tensor(arr, dtype=torch.float32).to(device=dev,
                                                              dtype=dt)
    return out


def train_state_from_numpy(cfg, tc, state: Mapping[str, Any], device=None
                           ) -> Dict[str, Any]:
    """The port's train state (:mod:`repro_torch.train.train_step`) from
    the reference's, as numpy arrays: ``step`` an int32 0-dim tensor, the
    float32 masters through :func:`params_from_numpy`, each optimizer slot
    in the dtype ``tc.opt`` gives it (bf16 ``m`` under ``m_dtype=
    "bfloat16"``: exact, since every bf16 value is a float32 value) and
    ``ef`` in float32, all on ``device`` (``None``: the card)."""
    from .train.optimizer import m_dtype
    dev = resolve_device(device)

    def tensor(a, dt):
        return torch.tensor(np.asarray(a, np.float32)).to(device=dev, dtype=dt)

    out = {"step": torch.tensor(int(np.asarray(state["step"])),
                                dtype=torch.int32, device=dev),
           "params": params_from_numpy(cfg, state["params"], device=dev,
                                       dtype=torch.float32),
           "opt": {k: tensor(v, m_dtype(tc.opt) if k.startswith("m.")
                             else torch.float32)
                   for k, v in state["opt"].items()}}
    if "ef" in state:
        out["ef"] = {k: tensor(v, torch.float32)
                     for k, v in state["ef"].items()}
    return out
