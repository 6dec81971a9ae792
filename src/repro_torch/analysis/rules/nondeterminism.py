"""Rule: wall-clock / host-RNG nondeterminism inside the captured round.

The port's copy of the reference's rule.  The engine's parity story
(device loop vs host loop, record-mode replay) requires the captured round
to be a pure function of its buffers and the sampler's Philox generator.
A ``time.time()`` / ``datetime.now()`` / ``np.random`` / ``random`` /
``uuid`` call inside it is baked in at *capture* time — every replay
reuses one frozen sample of it — and a ``torch.rand*`` call without
``generator=`` draws from the global generator, which the graph does not
register, so the device loop and the host loop consume different
streams and silently break the bitwise pins.
"""

from __future__ import annotations

import ast
from typing import Iterable, List

from ..findings import Finding
from ..lint import Rule, SourceModule, attr_chain

_BANNED_CHAINS = {
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "os.urandom", "uuid.uuid1", "uuid.uuid4",
    "secrets.token_bytes", "secrets.randbits",
}
_BANNED_PREFIXES = ("np.random.", "numpy.random.", "random.",
                    "datetime.now", "datetime.utcnow", "datetime.today",
                    "datetime.datetime.now", "datetime.datetime.utcnow",
                    "datetime.date.today")


class NondeterminismRule(Rule):
    name = "nondeterminism"
    description = ("wall-clock / host-RNG / uuid calls, torch.rand* without "
                   "generator=, inside the captured round")

    def check_module(self, mod: SourceModule) -> Iterable[Finding]:
        out: List[Finding] = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = mod.in_captured(node)
            if fn is None:
                continue
            chain = attr_chain(node.func)
            if not chain:
                continue
            hit = chain in _BANNED_CHAINS or any(
                chain == p.rstrip(".") or chain.startswith(p)
                for p in _BANNED_PREFIXES)
            if hit:
                out.append(Finding(
                    rule=self.name, path=mod.rel, line=node.lineno,
                    scope=mod.qualname(fn),
                    message=(f"nondeterministic call `{chain}()` inside "
                             "the captured round is frozen at capture "
                             "time"),
                    detail=chain))
            elif chain.startswith("torch.rand") and not any(
                    kw.arg == "generator" for kw in node.keywords):
                out.append(Finding(
                    rule=self.name, path=mod.rel, line=node.lineno,
                    scope=mod.qualname(fn),
                    message=(f"`{chain}()` without generator= draws from "
                             "the global generator inside the captured "
                             "round"),
                    detail=f"{chain}:no-generator"))
        return out
