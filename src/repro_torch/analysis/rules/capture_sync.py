"""Rule: host syncs inside the captured context.

The port's counterpart of the reference's ``tracer-branch`` and
``host-escape`` rules, which guard code under a jax trace.  The port's
device loop captures one round as a CUDA graph per capacity class and
replays it (:mod:`repro_torch.analysis.lint`: the captured context).  A
host sync there breaks the capture (a device→host copy is illegal while
capturing) or, on the CPU's eager chunks, costs one sync per round that
the design keeps to one per chunk.  Inside captured functions it flags:

* ``x.item()``, ``x.tolist()``, ``x.cpu()`` and ``x.numpy()``;
* ``int(x)``, ``float(x)`` or ``bool(x)`` of a tensor: an argument that
  mentions a ``torch.*`` call, a parameter of the captured function (not
  ``self``, not annotated as a Python scalar) or a local bound from a
  ``torch.*`` call;
* ``torch.cuda.synchronize()``.

Python control flow on a tensor (``if t:``) is a ``bool()`` of it and is
flagged the same way.
"""

from __future__ import annotations

import ast
from typing import Iterable, List, Optional, Set

from ..findings import Finding
from ..lint import Rule, SourceModule, attr_chain

_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_SCALAR_ANNOTATIONS = {"bool", "int", "float", "str", "None"}


def _is_static_annotation(ann: ast.AST) -> bool:
    """Python-scalar annotations (``Optional``, ``Union`` and tuples of
    them too) declare static config, not tensors."""
    if isinstance(ann, ast.Constant):
        return ann.value is None
    if isinstance(ann, ast.Name):
        return ann.id in _SCALAR_ANNOTATIONS
    if isinstance(ann, ast.Subscript) and isinstance(ann.value, ast.Name) \
            and ann.value.id in ("Optional", "Union", "Tuple", "tuple"):
        inner = ann.slice
        elts = inner.elts if isinstance(inner, ast.Tuple) else [inner]
        return all(_is_static_annotation(e) or (
            isinstance(e, ast.Constant) and e.value is Ellipsis)
            for e in elts)
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        return (_is_static_annotation(ann.left)
                and _is_static_annotation(ann.right))
    return False


def _torch_call(node: ast.AST) -> str:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            chain = attr_chain(sub.func)
            if chain.split(".", 1)[0] == "torch":
                return chain
    return ""


def _tensor_names(mod: SourceModule, fn: ast.FunctionDef) -> Set[str]:
    """Parameters of ``fn`` and of its captured ancestors, and the locals
    of ``fn`` bound from a ``torch.*`` call."""
    names: Set[str] = set()
    captured = mod.captured_functions()
    cur: Optional[ast.AST] = fn
    while cur is not None:
        if id(cur) in captured:
            a = cur.args
            for arg in a.posonlyargs + a.args + a.kwonlyargs:
                if arg.arg in ("self", "cls") or (
                        arg.annotation is not None
                        and _is_static_annotation(arg.annotation)):
                    continue
                names.add(arg.arg)
        cur = mod.enclosing_function(cur)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and _torch_call(node.value):
            for tgt in node.targets:
                for sub in ast.walk(tgt):
                    if isinstance(sub, ast.Name):
                        names.add(sub.id)
    return names


def _mentions_tensor(node: ast.AST, names: Set[str]) -> str:
    chain = _torch_call(node)
    if chain:
        return chain
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in names:
            return sub.id
    return ""


class CaptureSyncRule(Rule):
    name = "capture-sync"
    description = (".item()/.tolist()/.cpu()/.numpy(), int()/float()/bool() "
                   "of a tensor and torch.cuda.synchronize inside the "
                   "captured round")

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, (ast.Call, ast.If, ast.While,
                                     ast.IfExp)):
                continue
            fn = mod.in_captured(node)
            if fn is None:
                continue
            scope = mod.qualname(fn)
            hit = detail = ""
            if isinstance(node, ast.Call):
                chain = attr_chain(node.func)
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _SYNC_METHODS and not node.args:
                    hit = f"`.{node.func.attr}()` syncs with the host"
                    detail = node.func.attr
                elif chain == "torch.cuda.synchronize":
                    hit, detail = "`torch.cuda.synchronize()`", chain
                elif isinstance(node.func, ast.Name) and node.func.id in (
                        "int", "float", "bool") and node.args:
                    tok = _mentions_tensor(node.args[0],
                                           _tensor_names(mod, fn))
                    if tok:
                        hit = (f"`{node.func.id}({tok}...)` pulls a tensor "
                               "to the host")
                        detail = f"{node.func.id}:{tok}"
            else:
                test = node.test
                if not (isinstance(test, ast.Compare) and all(
                        isinstance(op, (ast.Is, ast.IsNot))
                        for op in test.ops)):
                    tok = _mentions_tensor(test, _tensor_names(mod, fn))
                    if tok and not _static_use(mod, test, tok):
                        kind = {"If": "if", "While": "while",
                                "IfExp": "ternary"}[type(node).__name__]
                        hit = (f"host `{kind}` on tensor `{tok}` (an "
                               "implicit bool())")
                        detail = f"{kind}:{tok}"
            if hit:
                out.append(Finding(
                    rule=self.name, path=mod.rel, line=node.lineno,
                    scope=scope, message=f"{hit} inside the captured round",
                    detail=detail))
        return out


_STATIC_ATTRS = {"shape", "ndim", "dtype", "device"}


def _static_use(mod: SourceModule, test: ast.AST, tok: str) -> bool:
    """Whether every use of ``tok`` in ``test`` reads static metadata
    (``t.shape``, ``cb.out.dtype``…)."""
    uses = [n for n in ast.walk(test) if isinstance(n, ast.Name)
            and n.id == tok]
    if not uses:
        return False
    for n in uses:
        node, static = mod.parent(n), False
        while isinstance(node, ast.Attribute):     # t.shape, cb.out.shape
            if node.attr in _STATIC_ATTRS:
                static = True
                break
            node = mod.parent(node)
        if not static:
            return False
    return True
