"""Static invariant gate: AST lint + trace/recompile audits.

The counterpart of the reference's ``scripts/analysis_gate.py``, run as
``python -m repro_torch.analysis``.  Three layers (see
:mod:`repro_torch.analysis`):

* ``ast`` — stdlib-only source lint of ``src/repro_torch`` (host syncs in
  the captured round, estimator pulls, fixed-point discipline,
  determinism, int32 packing guards, stats-vector widths, fallback
  accounting, lock discipline);
* ``trace`` — drives the UQ1 engines and checks that the unsharded engine
  issues no collective, that the world-1 sharded loops issue none either,
  and that the device and host loops consume the same Philox stream;
* ``recompile`` — drives the engines through mixed request sizes and
  checks one set of static buffers (and on the card one capture) per
  capacity class.

Findings already pinned in the baseline (the package's ``baseline.json``
by default; each entry carries a fingerprint and a one-line justification)
are suppressed; everything else makes the gate exit non-zero.

Usage::

    python -m repro_torch.analysis [paths...]        # default src/repro_torch
        [--baseline PATH]                # default: the package's baseline
        [--layers ast,trace,recompile]   # default: all three
        [--device cpu]                   # the audits' device (default: cuda)
        [--json] [--stats artifacts/analysis_stats.json] [--list-rules]

The reference's ``--require-jax`` has no counterpart: the audit layers need
only torch, which the port always has.  The audits run on the card, as
every entry point of the port does: there the recompile layer also checks
one CUDA-graph capture per capacity class.  Without a card they raise
(exit 2) unless ``--device cpu`` is given, which runs the same engines
eagerly (no capture to count).  The ``ast`` layer needs no device.
Exit codes: 0 clean (modulo baseline), 1 active findings, 2
usage/internal error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .findings import Baseline
from .lint import run_lint
from .rules import rule_catalog

_ALL_LAYERS = ("ast", "trace", "recompile")
HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_BASELINE = os.path.join(HERE, "baseline.json")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON of justified, suppressed findings")
    ap.add_argument("--layers", default=None,
                    help="comma list from {ast,trace,recompile}")
    ap.add_argument("--device", default=None,
                    help="the audits' torch device (default: cuda; 'cpu' "
                         "runs the engines eagerly)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as JSON on stdout")
    ap.add_argument("--stats", metavar="PATH", default=None,
                    help="write a findings-count JSON artifact to PATH")
    ap.add_argument("--list-rules", action="store_true")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 2 if e.code else 0

    if args.list_rules:
        for entry in sorted(rule_catalog(), key=lambda e: e["name"]):
            print(f"{entry['name']:18s} {entry['description']}")
        return 0

    paths = args.paths or [os.path.dirname(HERE)]
    layers = _ALL_LAYERS
    if args.layers:
        layers = tuple(s.strip() for s in args.layers.split(",") if s.strip())
        bad = set(layers) - set(_ALL_LAYERS)
        if bad:
            print(f"unknown layers: {sorted(bad)}", file=sys.stderr)
            return 2

    try:
        baseline = Baseline.load(args.baseline) if args.baseline \
            else Baseline()
    except (OSError, ValueError) as e:
        print(f"baseline {args.baseline}: {e}", file=sys.stderr)
        return 2

    findings = []
    reports = []
    if "ast" in layers:
        findings.extend(run_lint(paths))
    if {"trace", "recompile"} & set(layers):
        from ..device import resolve_device
        try:
            device = resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            print(f"analysis gate: {e}", file=sys.stderr)
            return 2
    if "trace" in layers:
        from .trace_audit import run_trace_audit
        f, r = run_trace_audit(device=device)
        findings.extend(f)
        reports.extend(r)
    if "recompile" in layers:
        from .recompile import run_recompile_audit
        f, r = run_recompile_audit(device=device)
        findings.extend(f)
        reports.extend(r)

    active, suppressed = baseline.split(findings)
    stale = baseline.stale(findings)

    by_rule = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    stats = {
        "layers": list(layers), "skipped_layers": [],
        "total": len(findings), "active": len(active),
        "suppressed": len(suppressed), "stale_baseline": len(stale),
        "by_rule": by_rule, "audits": reports,
    }

    if args.as_json:
        print(json.dumps({
            "stats": stats,
            "findings": [f.to_dict() for f in active],
            "suppressed": [f.to_dict() for f in suppressed],
        }, indent=2))
    else:
        for f in active:
            print(f.render())
        if suppressed:
            print(f"[baseline] {len(suppressed)} finding(s) suppressed")
        for fp in stale:
            print(f"[baseline] stale entry {fp}: no longer fires — "
                  "remove it from the baseline")
        print(f"analysis gate: {len(active)} active finding(s) across "
              f"{len(layers)} layer(s)")

    if args.stats:
        os.makedirs(os.path.dirname(args.stats) or ".", exist_ok=True)
        with open(args.stats, "w") as fh:
            json.dump(stats, fh, indent=2)

    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
