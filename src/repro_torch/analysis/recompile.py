"""Layer 2b: capture audit — one set of static buffers (and on the card one
CUDA-graph capture) per capacity class.

The counterpart of the reference's ``repro/analysis/recompile.py``, whose
device loop is compiled per output-capacity class ``C`` (the power-of-two
padding of the request size, floored at 1024).  The port's device loop
keeps one :class:`~repro_torch.core.backends.torch_backend._CallBuffers`
per class (``TorchUnionSampler._buffers``) and, on the card, captures one
round of the class as a CUDA graph the first time the class is asked for
(``_capture``; its seconds in ``capture_seconds``).  Every extra capture is
a stall of tens of milliseconds on the serving path, so the invariant
worth gating on is: across any mix of request sizes, a fresh engine holds
exactly one buffer set per distinct capacity class and captures each class
exactly once, never again for repeated sizes.  On the CPU the device loop
runs its step eagerly and captures nothing; the buffers are still one per
class.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

from ..core.backends.torch_backend import capacity_class
from .findings import Finding


def _finding(label: str, message: str, detail: str) -> Finding:
    return Finding(rule="recompile", path=f"<audit:{label}>", line=0,
                   scope=label, message=message, detail=detail)


def audit_recompile_engine(eng, label: str,
                           sizes: Sequence[int] = (200, 300, 1400, 1500, 300)
                           ) -> Tuple[List[Finding], Dict[str, Any]]:
    """Drive a fresh engine through a mix of request sizes and count its
    buffer sets and captures.

    ``sizes`` deliberately repeats a capacity class (200/300 → C=1024,
    1400/1500 → C=2048, then 300 again) so a cache keyed on anything
    finer than the capacity class shows up as a duplicate."""
    captures: List[int] = []
    capture = eng._capture

    def counted(cb):
        captures.append(cb.C)
        return capture(cb)

    eng._capture = counted
    try:
        for n in sizes:
            eng.sample(n)
    finally:
        del eng._capture
    classes = sorted({capacity_class(n) for n in sizes})
    findings: List[Finding] = []
    if sorted(eng._buffers) != classes:
        findings.append(_finding(
            label, "static buffers are not one set per capacity class",
            f"buffers={sorted(eng._buffers)} expected={classes}"))
    graphs = eng._graphs()
    want = classes if graphs else []
    if sorted(captures) != want:
        findings.append(_finding(
            label, "CUDA-graph captures differ from one per capacity class",
            f"captures={sorted(captures)} expected={want}"))
    if sorted(eng.capture_seconds) != want:
        findings.append(_finding(
            label, "capture_seconds keys are not the capacity classes",
            f"keys={sorted(eng.capture_seconds)} expected={want}"))
    report = {
        "label": label, "plan": eng.plan, "sizes": list(sizes),
        "device": str(eng.device), "graphs": graphs,
        "capacity_classes": classes, "buffers": sorted(eng._buffers),
        "captures": len(captures),
        "capture_seconds": {str(k): v for k, v in
                            sorted(eng.capture_seconds.items())},
        "findings": len(findings),
    }
    return findings, report


# plan regimes get distinct engines (the carry's layout is plan-dependent)
DEFAULT_RECOMPILE_AUDITS: Tuple[Tuple[str, Dict[str, Any]], ...] = (
    ("uq1-static", dict(workload="uq1", plan="static")),
    ("uq1-adaptive", dict(workload="uq1", plan="adaptive")),
    ("uq4-static", dict(workload="uq4", plan="static")),
)


def run_recompile_audit(audits: Sequence[Tuple[str, Dict[str, Any]]] = None,
                        device=None
                        ) -> Tuple[List[Finding], List[Dict[str, Any]]]:
    """Run the audit matrix on ``device`` (``None``: the card, where each
    class is also captured once); returns (findings, per-audit reports)."""
    from .trace_audit import build_engine

    findings: List[Finding] = []
    reports: List[Dict[str, Any]] = []
    for label, spec in (audits if audits is not None
                        else DEFAULT_RECOMPILE_AUDITS):
        eng = build_engine(device=device, **spec)
        f, r = audit_recompile_engine(eng, label)
        findings.extend(f)
        reports.append(r)
    return findings, reports
