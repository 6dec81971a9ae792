"""Rule: SamplerStats counter-vector widths must agree everywhere.

The port's copy of the reference's rule, over ``repro_torch``: the
canonical tuples live in ``core/backends/torch_backend.py``.  The device
loop carries a ``len(_STAT_FIELDS)``-wide int32 stats vector
and a ``(n_pieces, len(PIECE_STAT_FIELDS))`` telemetry matrix; the host
twin, the sharded engine and the telemetry fold all assume those widths.
A field added to one stack literal but not the constants (or vice versa)
shears the fold silently — counters land in the wrong buckets.

Project-wide checks:

1. every ``_STAT_FIELDS`` name is a real ``SamplerStats`` dataclass
   field (renames break the snapshot fold);
2. no module *re-defines* ``_STAT_FIELDS`` / ``PIECE_STAT_FIELDS`` —
   the sharded engine and estimators must import the canonical tuples;
3. in modules using the constants, stack literals assigned to
   ``stats*`` / ``pstats*`` names must have exactly
   ``len(_STAT_FIELDS)`` / ``len(PIECE_STAT_FIELDS)`` elements.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from ..findings import Finding
from ..lint import Rule, SourceModule, attr_chain

_CANON_SUFFIX = "backends/torch_backend.py"
_STATS_NAME = re.compile(r"^stats\d*$")
_PSTATS_NAME = re.compile(r"^pstats\d*$")


def _module_tuple(mod: SourceModule, name: str
                  ) -> Optional[Tuple[ast.Assign, List[str]]]:
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == name \
                and isinstance(node.value, (ast.Tuple, ast.List)):
            vals = [e.value for e in node.value.elts
                    if isinstance(e, ast.Constant)]
            return node, [v for v in vals if isinstance(v, str)]
    return None


def _dataclass_fields(mod: SourceModule, cls_name: str) -> List[str]:
    for cls in mod.classes:
        if cls.name != cls_name:
            continue
        return [stmt.target.id for stmt in cls.body
                if isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)]
    return []


def _stack_width(value: ast.AST) -> Optional[Tuple[int, int]]:
    """(n_elements, lineno) of a torch/np.stack([...]) inside ``value``."""
    for sub in ast.walk(value):
        if not isinstance(sub, ast.Call):
            continue
        chain = attr_chain(sub.func)
        if chain.rsplit(".", 1)[-1] != "stack":
            continue
        if sub.args and isinstance(sub.args[0], (ast.List, ast.Tuple)):
            return len(sub.args[0].elts), sub.lineno
    return None


class StatsWidthRule(Rule):
    name = "stats-width"
    description = ("SamplerStats / _STAT_FIELDS / PIECE_STAT_FIELDS width "
                   "and provenance agreement across engines")

    def check_project(self, mods: Sequence[SourceModule]
                      ) -> Iterable[Finding]:
        canon = next((m for m in mods if m.rel.endswith(_CANON_SUFFIX)),
                     None)
        stats_holder = next(
            (m for m in mods if m.rel.endswith("core/union_sampler.py")),
            None)
        if canon is None:
            return ()               # not analyzing the engine tree
        out: List[Finding] = []
        widths: Dict[str, int] = {}
        for const in ("_STAT_FIELDS", "PIECE_STAT_FIELDS"):
            found = _module_tuple(canon, const)
            if found is None:
                out.append(Finding(
                    rule=self.name, path=canon.rel, line=1,
                    scope="<module>",
                    message=f"canonical `{const}` tuple not found",
                    detail=f"missing:{const}"))
                continue
            node, names = found
            widths[const] = len(names)
            # (1) _STAT_FIELDS names must be SamplerStats dataclass fields
            if const == "_STAT_FIELDS" and stats_holder is not None:
                fields = set(_dataclass_fields(stats_holder, "SamplerStats"))
                for n in names:
                    if fields and n not in fields:
                        out.append(Finding(
                            rule=self.name, path=canon.rel,
                            line=node.lineno, scope="<module>",
                            message=(f"`_STAT_FIELDS` entry {n!r} is not a "
                                     "SamplerStats dataclass field"),
                            detail=f"field:{n}"))
        # (2) shadow re-definitions elsewhere
        for mod in mods:
            if mod is canon:
                continue
            for const in ("_STAT_FIELDS", "PIECE_STAT_FIELDS"):
                found = _module_tuple(mod, const)
                if found is not None:
                    out.append(Finding(
                        rule=self.name, path=mod.rel,
                        line=found[0].lineno, scope="<module>",
                        message=(f"`{const}` re-defined here; import the "
                                 "canonical tuple from torch_backend"),
                        detail=f"shadow:{const}"))
        # (3) stack-literal widths in modules that use the constants
        for mod in mods:
            if "_STAT_FIELDS" not in mod.text:
                continue
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Assign) \
                        or len(node.targets) != 1 \
                        or not isinstance(node.targets[0], ast.Name):
                    continue
                tname = node.targets[0].id
                want = None
                const = None
                if _STATS_NAME.match(tname):
                    const, want = "_STAT_FIELDS", widths.get("_STAT_FIELDS")
                elif _PSTATS_NAME.match(tname):
                    const = "PIECE_STAT_FIELDS"
                    want = widths.get("PIECE_STAT_FIELDS")
                if want is None:
                    continue
                got = _stack_width(node.value)
                if got is None:
                    continue
                n, line = got
                if n != want:
                    out.append(Finding(
                        rule=self.name, path=mod.rel, line=line,
                        scope=mod.scope_of(node),
                        message=(f"stack literal assigned to `{tname}` has "
                                 f"{n} elements but `{const}` has {want}"),
                        detail=f"width:{tname}:{n}"))
        return out
