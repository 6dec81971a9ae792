"""Rule: host-degrade branches must emit ``repro_engine_fallback_total``.

The port's copy of the reference's rule.  Every place the engine silently degrades — backend substitution,
unsupported-mode rerouting, host-oracle fallback — warns the user.  The
observability contract (DESIGN.md §10) says each such branch *also*
calls :func:`repro_torch.obs.record_fallback` so operators see degrades in
metrics, not just in stderr scrollback.

The rule anchors on the warning: any ``warnings.warn(...)`` (or bare
``warn(...)``) whose message text reads like a degrade ("fall back",
"fallback", "falls back", "degrad…") inside a function that never calls
``record_fallback`` is a silent-degrade branch.
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List

from ..findings import Finding
from ..lint import Rule, SourceModule, attr_chain

_DEGRADE_RE = re.compile(r"fall\w*[\s-]*back|fallback|degrad", re.I)


def _literal_text(node: ast.AST) -> str:
    """Concatenated string-constant content of a warn() argument."""
    parts: List[str] = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            parts.append(sub.value)
    return " ".join(parts)


class MissingFallbackRule(Rule):
    name = "missing-fallback"
    description = ("degrade-path warnings.warn without a record_fallback "
                   "call in the same function")

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = attr_chain(node.func)
            if chain not in ("warn", "warnings.warn"):
                continue
            if not node.args:
                continue
            text = _literal_text(node.args[0])
            if not _DEGRADE_RE.search(text):
                continue
            fn = mod.enclosing_function(node)
            haystack = fn if fn is not None else mod.tree
            has_record = any(
                isinstance(c, ast.Call)
                and attr_chain(c.func).rsplit(".", 1)[-1] == "record_fallback"
                for c in ast.walk(haystack))
            if has_record:
                continue
            core = re.sub(r"\s+", " ", text)[:60]
            out.append(Finding(
                rule=self.name, path=mod.rel, line=node.lineno,
                scope=mod.scope_of(node),
                message=("degrade warning without obs.record_fallback in "
                         f"the same function: \"{core}...\""),
                detail=core[:40]))
        return out
