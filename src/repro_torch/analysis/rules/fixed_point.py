"""Rule: float contamination in fixed-point planner arithmetic.

The port's copy of the reference's rule.  Functions marked
``# analysis: fixed-point`` (the planner's ``budget_for`` / ``ema_update``
and any future device-carried integer arithmetic) must stay bit-identical
between numpy and torch (``planner.TORCH_XP``), and with the reference.
That holds only while every operation is integer: a float literal, a true
division, or an f64-promoting cast silently drifts the two sides apart
(numpy promotes to float64, torch to float32).

Flags, inside marked functions: float/complex literals, ``/`` (true
division), ``float()`` / ``np.float64`` / ``torch.float64`` /
``np.float32`` / ``torch.float32`` conversion calls, ``.astype(...)`` to a
float dtype, and ``**`` with a float operand.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from ..findings import Finding
from ..lint import Rule, SourceModule, attr_chain

_FLOAT_CASTS = {"float", "float16", "float32", "float64", "double"}


def _is_float_const(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(
        node.value, (float, complex))


class FixedPointRule(Rule):
    name = "f64-in-planner"
    description = ("float literals / true division / float casts inside "
                   "`# analysis: fixed-point` functions")

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        out: List[Finding] = []
        for fn in mod.defs:
            if not mod.has_marker(fn, "fixed-point"):
                continue
            scope = mod.qualname(fn)
            for node in ast.walk(fn):
                if _is_float_const(node):
                    out.append(Finding(
                        rule=self.name, path=mod.rel, line=node.lineno,
                        scope=scope,
                        message=f"float literal {node.value!r} in "
                                "fixed-point function",
                        detail=f"literal:{node.value!r}"))
                elif isinstance(node, ast.BinOp) and isinstance(
                        node.op, ast.Div):
                    out.append(Finding(
                        rule=self.name, path=mod.rel, line=node.lineno,
                        scope=scope,
                        message="true division `/` in fixed-point function "
                                "(use `//` or shifts)",
                        detail="div"))
                elif isinstance(node, ast.BinOp) and isinstance(
                        node.op, ast.Pow) and (
                        _is_float_const(node.left)
                        or _is_float_const(node.right)):
                    out.append(Finding(
                        rule=self.name, path=mod.rel, line=node.lineno,
                        scope=scope,
                        message="float power in fixed-point function",
                        detail="pow"))
                elif isinstance(node, ast.Call):
                    chain = attr_chain(node.func)
                    tail = chain.rsplit(".", 1)[-1]
                    if tail in _FLOAT_CASTS:
                        out.append(Finding(
                            rule=self.name, path=mod.rel, line=node.lineno,
                            scope=scope,
                            message=f"float cast `{chain}()` in "
                                    "fixed-point function",
                            detail=f"cast:{chain}"))
                    elif tail == "astype" and node.args and any(
                            (isinstance(a, ast.Attribute)
                             and a.attr in _FLOAT_CASTS)
                            or (isinstance(a, ast.Name)
                                and a.id in _FLOAT_CASTS)
                            for a in node.args):
                        out.append(Finding(
                            rule=self.name, path=mod.rel, line=node.lineno,
                            scope=scope,
                            message="`.astype(float...)` in fixed-point "
                                    "function",
                            detail="astype"))
        return out
