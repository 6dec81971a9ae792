"""Finding records, stable fingerprints, and the suppression baseline.

A finding's *fingerprint* deliberately excludes line numbers: it hashes
``rule | path | scope | detail`` so that unrelated edits to a file don't
churn the baseline.  ``detail`` is the rule's stable token for the
offending construct (a symbol name, an attribute, a message core) rather
than the rendered message.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Iterable, List, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str            # rule identifier, e.g. "host-escape"
    path: str            # repo-relative posix path
    line: int            # 1-based line of the offending node
    scope: str           # dotted qualname of the enclosing def/class
    message: str         # human-readable description
    detail: str = ""     # stable token used for the fingerprint

    @property
    def fingerprint(self) -> str:
        core = f"{self.rule}|{self.path}|{self.scope}|{self.detail or self.message}"
        return hashlib.sha1(core.encode()).hexdigest()[:16]

    def to_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "scope": self.scope,
            "message": self.message,
            "fingerprint": self.fingerprint,
        }

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] {self.message} "
                f"(in {self.scope}) [{self.fingerprint}]")


class Baseline:
    """Grandfathered findings: ``{fingerprint: reason}`` with a policy that
    every entry carries a one-line justification (enforced on load)."""

    def __init__(self, entries: Optional[Dict[str, Dict[str, str]]] = None):
        self.entries: Dict[str, Dict[str, str]] = dict(entries or {})

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, encoding="utf-8") as fh:
            raw = json.load(fh)
        entries: Dict[str, Dict[str, str]] = {}
        for item in raw.get("findings", []):
            fp = item.get("fingerprint", "")
            reason = (item.get("reason") or "").strip()
            if not fp:
                raise ValueError(f"baseline entry missing fingerprint: {item}")
            if not reason:
                raise ValueError(
                    f"baseline entry {fp} has no justification reason")
            entries[fp] = item
        return cls(entries)

    def suppresses(self, finding: Finding) -> bool:
        return finding.fingerprint in self.entries

    def split(self, findings: Sequence[Finding]
              ) -> tuple[List[Finding], List[Finding]]:
        """(active, suppressed) partition of ``findings``."""
        active = [f for f in findings if not self.suppresses(f)]
        suppressed = [f for f in findings if self.suppresses(f)]
        return active, suppressed

    def stale(self, findings: Iterable[Finding]) -> List[str]:
        """Baseline fingerprints no longer matched by any current finding —
        candidates for deletion so the baseline shrinks over time."""
        seen = {f.fingerprint for f in findings}
        return sorted(fp for fp in self.entries if fp not in seen)
