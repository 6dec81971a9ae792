"""Rule: device-backed estimator stats pulled on the sampling hot path.

The port's copy of the reference's ``estimator-pull`` rule
(``repro/analysis/rules/host_escape.py``).  In sampler classes that read
the estimation subsystem's device-backed running stats (``size_stats`` /
``overlap_stats``), the ``.mean`` / ``.count`` / ``.variance`` /
``.half_width`` properties each pull a device scalar to the host.
Reading them from sampling-hot-path methods re-syncs unchanged state once
per candidate; those reads belong in the refresh path (method names
starting with ``_refresh``, ``observe``, ``warm`` or ``__init__``) with the
host floats memoised for the hot path (the port's
``OnlineUnionSampler._refresh_size_cache``).
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Set

from ..findings import Finding
from ..lint import Rule, SourceModule

_PULL_PROPS = {"mean", "count", "variance", "m2", "half_width"}
_STATS_TAILS = {"size_stats", "overlap_stats"}
_EXEMPT_PREFIXES = ("_refresh", "__init__", "observe", "warm")


class EstimatorPullRule(Rule):
    name = "estimator-pull"
    description = ("device-backed running-stat properties read outside the "
                   "refresh path (per-candidate device→host syncs)")

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        out: List[Finding] = []
        for cls in mod.classes:
            methods = [n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
            if not any(m.name == "sample" for m in methods):
                continue            # only sampler front-ends have a hot path
            for meth in methods:
                if meth.name.startswith(_EXEMPT_PREFIXES):
                    continue
                stat_vars = self._stat_vars(meth)
                if not stat_vars:
                    continue
                for node in ast.walk(meth):
                    read = None
                    if (isinstance(node, ast.Attribute)
                            and node.attr in _PULL_PROPS
                            and isinstance(node.value, ast.Name)
                            and node.value.id in stat_vars):
                        read = f"{node.value.id}.{node.attr}"
                    if read is None:
                        continue
                    out.append(Finding(
                        rule=self.name, path=mod.rel, line=node.lineno,
                        scope=mod.qualname(meth),
                        message=(f"`{read}` pulls a device stat scalar in "
                                 f"`{meth.name}` (hot path); memoise it in "
                                 "the refresh path instead"),
                        detail=f"{meth.name}:{read}"))
        return out

    @staticmethod
    def _stat_vars(meth: ast.AST) -> Set[str]:
        """Local names bound from ``*.size_stats`` / ``*.overlap_stats``."""
        names: Set[str] = set()
        for node in ast.walk(meth):
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            tgt = node.targets[0]
            if not isinstance(tgt, ast.Name):
                continue
            for sub in ast.walk(node.value):
                if isinstance(sub, ast.Attribute) \
                        and sub.attr in _STATS_TAILS:
                    names.add(tgt.id)
                    break
        return names
