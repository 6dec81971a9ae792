"""Layer-1 lint engine: module loading, captured-context index, rule runner.

The port's copy of the reference's ``repro/analysis/lint.py``.  Everything
here is stdlib-only (``ast`` + friends), so the gate runs on a bare
interpreter.

Captured-context detection
--------------------------
The reference's *traced* context (code under ``jax.jit`` / ``lax.scan`` /
``shard_map``…) becomes the port's **captured** context: code that the
device loop records into a CUDA graph, one per capacity class, and
replays (``TorchUnionSampler._capture``).  A host sync there either breaks
the capture or freezes one value into every replay.  A function is
captured when any of these hold:

* it is a round entry of the device loop (:data:`CAPTURE_ENTRIES`:
  ``_round_core`` and ``_round_step`` in ``core/backends/torch_backend.py``
  and ``core/sharding/sampler.py``, ``_shard_step`` in the latter);
* its ``def`` line (or the line above) carries an ``# analysis: captured``
  marker;
* it is defined inside, or called from, a captured function (transitive
  closure over same-module calls: bare ``f(...)`` to a sibling def, or
  ``self.m(...)`` to a method of the enclosing class).

Inline suppression: a line carrying ``# analysis: allow(rule-name)`` (or
``allow(*)``) suppresses findings of that rule anchored to that line.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

from .findings import Finding

# module path suffix -> names of the device loop's round entries there
CAPTURE_ENTRIES = {
    "core/backends/torch_backend.py": ("_round_core", "_round_step"),
    "core/sharding/sampler.py": ("_round_core", "_round_step",
                                 "_shard_step"),
}

_ALLOW_RE = re.compile(r"#\s*analysis:\s*allow\(([^)]*)\)")
_MARK_RE = re.compile(r"#\s*analysis:\s*(captured|fixed-point)\b")


def attr_tail(node: ast.AST) -> Optional[str]:
    """Last segment of a Name / dotted-attribute expression, else None."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def attr_chain(node: ast.AST) -> str:
    """Render ``a.b.c`` chains (best effort) for messages."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    return ".".join(reversed(parts))


class SourceModule:
    """One parsed file plus navigation helpers shared by all rules."""

    def __init__(self, path: str, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self._parents: Dict[int, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self._parents[id(child)] = node
        self.defs: List[ast.FunctionDef] = [
            n for n in ast.walk(self.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        self.classes: List[ast.ClassDef] = [
            n for n in ast.walk(self.tree) if isinstance(n, ast.ClassDef)]
        self._captured: Optional[Set[int]] = None

    # -- navigation -----------------------------------------------------------
    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(id(node))

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parent(node)
        while cur is not None:
            yield cur
            cur = self.parent(cur)

    def enclosing_function(self, node: ast.AST
                           ) -> Optional[ast.FunctionDef]:
        for a in self.ancestors(node):
            if isinstance(a, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return a
        return None

    def enclosing_class(self, node: ast.AST) -> Optional[ast.ClassDef]:
        for a in self.ancestors(node):
            if isinstance(a, ast.ClassDef):
                return a
        return None

    def qualname(self, node: ast.AST) -> str:
        parts: List[str] = []
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            cur = self.parent(cur)
        return ".".join(reversed(parts)) or "<module>"

    def scope_of(self, node: ast.AST) -> str:
        fn = self.enclosing_function(node)
        if fn is not None:
            return self.qualname(fn)
        cls = self.enclosing_class(node)
        if cls is not None:
            return self.qualname(cls)
        return "<module>"

    # -- source markers -------------------------------------------------------
    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def has_marker(self, node: ast.AST, marker: str) -> bool:
        """``# analysis: <marker>`` on the node's line or the line above."""
        for ln in (node.lineno, node.lineno - 1):
            m = _MARK_RE.search(self.line_text(ln))
            if m and m.group(1) == marker:
                return True
        return False

    def allowed_rules(self, lineno: int) -> Set[str]:
        m = _ALLOW_RE.search(self.line_text(lineno))
        if not m:
            return set()
        return {tok.strip() for tok in m.group(1).split(",") if tok.strip()}

    # -- captured-context index -----------------------------------------------
    def captured_functions(self) -> Set[int]:
        """ids of FunctionDef nodes whose bodies a CUDA graph captures."""
        if self._captured is not None:
            return self._captured
        captured: Set[int] = set()
        entries = next((names for suffix, names in CAPTURE_ENTRIES.items()
                        if self.rel.endswith(suffix)), ())

        # (1) the round entries + explicit markers
        for fn in self.defs:
            if self.has_marker(fn, "captured") or (
                    fn.name in entries
                    and isinstance(self.parent(fn), ast.ClassDef)):
                captured.add(id(fn))

        # (2) transitive closure: nested defs + same-module calls
        changed = True
        while changed:
            before = len(captured)
            for fn in self.defs:
                if id(fn) not in captured:
                    continue
                for node in ast.walk(fn):
                    if node is not fn and isinstance(
                            node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        captured.add(id(node))
                    elif isinstance(node, ast.Call):
                        callee = self._resolve_callee(node, fn)
                        if callee is not None:
                            captured.add(id(callee))
            changed = len(captured) != before

        self._captured = captured
        return captured

    def _resolve_callee(self, call: ast.Call, site_fn: ast.AST
                        ) -> Optional[ast.FunctionDef]:
        f = call.func
        if isinstance(f, ast.Name):
            return self._lookup_def(f.id, call)
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id == "self"):
            return self._lookup_method(f.attr, call)
        return None

    def _lookup_def(self, name: str, site: ast.AST
                    ) -> Optional[ast.FunctionDef]:
        """Nearest def named ``name`` in the site's enclosing scope chain."""
        scopes: List[ast.AST] = []
        fn = self.enclosing_function(site)
        while fn is not None:
            scopes.append(fn)
            fn = self.enclosing_function(fn)
        scopes.append(self.tree)
        for scope in scopes:
            body = scope.body if hasattr(scope, "body") else []
            for stmt in body:
                if (isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and stmt.name == name):
                    return stmt
        return None

    def _lookup_method(self, name: str, site: ast.AST
                       ) -> Optional[ast.FunctionDef]:
        cls = self.enclosing_class(site)
        if cls is None:
            return None
        for stmt in cls.body:
            if (isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and stmt.name == name):
                return stmt
        return None

    def in_captured(self, node: ast.AST) -> Optional[ast.FunctionDef]:
        """The innermost captured function enclosing ``node``, if any."""
        captured = self.captured_functions()
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and id(cur) in captured:
                return cur
            cur = self.parent(cur)
        return None


class Rule:
    """Base class: subclasses set ``name`` and override one of the hooks."""

    name = "rule"
    description = ""

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        return ()

    def check_project(self, mods: Sequence[SourceModule]
                      ) -> Iterable[Finding]:
        return ()


def load_tree(root: str, rel_prefix: str = "") -> List[SourceModule]:
    """Parse every ``*.py`` under ``root`` (sorted, skipping caches)."""
    mods: List[SourceModule] = []
    root = os.path.abspath(root)
    if os.path.isfile(root):
        with open(root, encoding="utf-8") as fh:
            text = fh.read()
        rel = os.path.join(rel_prefix, os.path.basename(root))
        return [SourceModule(root, rel.replace(os.sep, "/"), text)]
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.join(rel_prefix, os.path.relpath(path, root))
            with open(path, encoding="utf-8") as fh:
                text = fh.read()
            mods.append(SourceModule(path, rel.replace(os.sep, "/"), text))
    return mods


def run_lint(paths: Sequence[str], rules: Optional[Sequence[Rule]] = None,
             rel_prefixes: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run all (or the given) rules over the files/trees in ``paths``."""
    if rules is None:
        from .rules import all_rules
        rules = all_rules()
    mods: List[SourceModule] = []
    for i, p in enumerate(paths):
        if rel_prefixes:
            prefix = rel_prefixes[i]
        elif os.path.isfile(p):
            prefix = ""              # a file already names itself
        else:
            prefix = os.path.basename(os.path.abspath(p))
        mods.extend(load_tree(p, rel_prefix=prefix))
    findings: List[Finding] = []
    for rule in rules:
        for mod in mods:
            findings.extend(rule.check_module(mod))
        findings.extend(rule.check_project(mods))
    # inline `# analysis: allow(rule)` suppression at the finding's line
    by_rel = {m.rel: m for m in mods}
    kept: List[Finding] = []
    for f in findings:
        mod = by_rel.get(f.path)
        if mod is not None:
            allowed = mod.allowed_rules(f.line)
            if f.rule in allowed or "*" in allowed:
                continue
        kept.append(f)
    kept.sort(key=lambda f: (f.path, f.line, f.rule))
    return kept
