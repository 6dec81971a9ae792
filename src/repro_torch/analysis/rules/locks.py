"""Layer-3 rule: lock discipline in the serve tier and obs registry.

The port's copy of the reference's rule.

Two hazards, both scoped per class:

* **Unlocked writes to guarded attributes.**  If a method writes
  ``self.x`` inside a ``with self._lock:`` block, ``x`` is part of that
  lock's protected state; any *other* write to ``self.x`` outside a lock
  block (``__init__`` excepted — no concurrent access before the object
  escapes the constructor) is a data race with the guarded readers.

* **Blocking queue/thread operations while holding a lock.**  A
  ``q.get()`` / ``q.put(item)`` without a ``timeout`` (or
  ``block=False``), or a zero-argument ``.join()``, executed inside a
  ``with self._lock:`` block can deadlock against a producer/drain
  thread that needs the same lock to make progress — the exact shape of
  the ``sample_async`` drain in ``serve/service.py``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Set, Tuple

from ..findings import Finding
from ..lint import Rule, SourceModule, attr_chain

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}


def _self_attr(node: ast.AST) -> str:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return ""


def _lock_attrs(cls: ast.ClassDef) -> Set[str]:
    names: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            tail = attr_chain(node.value.func).rsplit(".", 1)[-1]
            if tail in _LOCK_CTORS:
                for tgt in node.targets:
                    attr = _self_attr(tgt)
                    if attr:
                        names.add(attr)
    return names


def _with_lock_blocks(meth: ast.AST, locks: Set[str]
                      ) -> List[Tuple[str, ast.With]]:
    out: List[Tuple[str, ast.With]] = []
    for node in ast.walk(meth):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        for item in node.items:
            expr = item.context_expr
            if isinstance(expr, ast.Call):
                expr = expr.func            # self._lock.acquire-style
            attr = _self_attr(expr)
            if attr in locks:
                out.append((attr, node))
    return out


class LockDisciplineRule(Rule):
    name = "lock-discipline"
    description = ("guarded attributes written outside the lock; blocking "
                   "queue/join calls while holding a lock")

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        out: List[Finding] = []
        for cls in mod.classes:
            locks = _lock_attrs(cls)
            if not locks:
                continue
            methods = [n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
            guarded: Dict[str, int] = {}      # attr -> first guarded line
            locked_nodes: Set[int] = set()    # ids of nodes under a lock
            for meth in methods:
                for _lname, blk in _with_lock_blocks(meth, locks):
                    for sub in ast.walk(blk):
                        locked_nodes.add(id(sub))
                        if isinstance(sub, (ast.Assign, ast.AugAssign)):
                            tgts = (sub.targets
                                    if isinstance(sub, ast.Assign)
                                    else [sub.target])
                            for tgt in tgts:
                                attr = _self_attr(tgt)
                                if attr and attr not in locks:
                                    guarded.setdefault(attr, sub.lineno)
            # unlocked writes to guarded attrs (outside __init__)
            for meth in methods:
                if meth.name in ("__init__", "__new__"):
                    continue
                for sub in ast.walk(meth):
                    if id(sub) in locked_nodes:
                        continue
                    if not isinstance(sub, (ast.Assign, ast.AugAssign)):
                        continue
                    tgts = (sub.targets if isinstance(sub, ast.Assign)
                            else [sub.target])
                    for tgt in tgts:
                        attr = _self_attr(tgt)
                        if attr and attr in guarded:
                            out.append(Finding(
                                rule=self.name, path=mod.rel,
                                line=sub.lineno,
                                scope=mod.qualname(meth),
                                message=(f"`self.{attr}` is written under "
                                         "the lock elsewhere (line "
                                         f"{guarded[attr]}) but written "
                                         "here without it"),
                                detail=f"unlocked:{attr}"))
            # blocking queue/thread ops while holding a lock
            for meth in methods:
                for _lname, blk in _with_lock_blocks(meth, locks):
                    for sub in ast.walk(blk):
                        if not isinstance(sub, ast.Call) \
                                or not isinstance(sub.func, ast.Attribute):
                            continue
                        tail = sub.func.attr
                        kwargs = {kw.arg for kw in sub.keywords}
                        if "timeout" in kwargs or "block" in kwargs:
                            continue
                        recv = attr_chain(sub.func.value)
                        hazard = ""
                        if tail == "put" and sub.args:
                            hazard = "blocking put()"
                        elif tail == "get" and not sub.args:
                            hazard = "blocking get()"
                        elif tail == "join" and not sub.args:
                            hazard = "join()"
                        if not hazard or recv.endswith(tuple(locks)):
                            continue
                        out.append(Finding(
                            rule=self.name, path=mod.rel, line=sub.lineno,
                            scope=mod.qualname(meth),
                            message=(f"{hazard} on `{recv}` without a "
                                     "timeout while holding "
                                     f"`self.{_lname}` can deadlock the "
                                     "drain thread"),
                            detail=f"blocking:{recv}.{tail}"))
        return out
