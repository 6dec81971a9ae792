"""Rule: int32 overflow guards around packed composite keys.

The port's copy of the reference's rule.  The engine packs multi-attribute join keys into int32 by mixed-radix
accumulation (``key = key * width + col``).  The product of radices must
be checked against ``2**31`` *before* packing — otherwise the packed key
silently wraps and the sorted-index probes return wrong rows.  The
canonical guards are ``_I32_LIM`` comparisons and
``(dom).bit_length()``-style error messages (``_as_i32`` carries its own
check).

This rule finds mixed-radix accumulation loops — a ``for`` loop whose
body folds ``x = x * w + c`` (or ``x *= w`` / ``x += c``) — in modules
that do int32 key work, and flags them when the module carries none of
the guard idioms (``_I32_LIM``, ``bit_length``, ``_as_i32``, a literal
``1 << 31`` / ``2147483648``).
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, List

from ..findings import Finding
from ..lint import Rule, SourceModule

_GUARD_TOKENS = ("_I32_LIM", "bit_length", "_as_i32", "2147483648",
                 "2 ** 31", "2**31")
# any `1 << NN` bound with NN >= 31 counts as a domain guard (the int64
# fingerprint pack in relation.py guards against 1 << 62)
_GUARD_SHIFT_RE = re.compile(r"1\s*<<\s*(3[1-9]|[4-9]\d)")


def _mul_add_fold(stmt: ast.stmt) -> str:
    """Name folded by ``x = x * w + c`` / ``x *= w`` inside a loop body."""
    if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 \
            and isinstance(stmt.targets[0], ast.Name):
        name = stmt.targets[0].id
        v = stmt.value
        if isinstance(v, ast.BinOp) and isinstance(v.op, ast.Add):
            left = v.left
            if isinstance(left, ast.BinOp) and isinstance(left.op, ast.Mult):
                for sub in ast.walk(left):
                    if isinstance(sub, ast.Name) and sub.id == name:
                        return name
    if isinstance(stmt, ast.AugAssign) and isinstance(stmt.op, ast.Mult) \
            and isinstance(stmt.target, ast.Name):
        return stmt.target.id
    return ""


class Int32PackingRule(Rule):
    name = "int32-overflow"
    description = ("mixed-radix key packing without an int32 domain guard "
                   "(_I32_LIM / bit_length / _as_i32)")

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        if "/core/" not in f"/{mod.rel}":
            return ()               # key packing lives in the core engine
        if "int32" not in mod.text:
            return ()               # module does no int32 key work
        if any(tok in mod.text for tok in _GUARD_TOKENS) \
                or _GUARD_SHIFT_RE.search(mod.text):
            return ()               # guard idiom present somewhere in module
        out: List[Finding] = []
        for loop in ast.walk(mod.tree):
            if not isinstance(loop, ast.For):
                continue
            for stmt in ast.walk(loop):
                if not isinstance(stmt, (ast.Assign, ast.AugAssign)):
                    continue
                name = _mul_add_fold(stmt)
                if not name:
                    continue
                out.append(Finding(
                    rule=self.name, path=mod.rel, line=stmt.lineno,
                    scope=mod.scope_of(stmt),
                    message=(f"mixed-radix accumulation on `{name}` in an "
                             "int32 module without a 2**31 domain guard"),
                    detail=f"fold:{name}"))
                break               # one finding per loop is enough
        return out
