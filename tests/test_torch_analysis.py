"""The port's static invariant analysis (``repro_torch.analysis``): rule
fixtures, baseline policy, the gate, and the trace and capture audits on
the real engines, on the CPU.

Layer 1/3 (AST lint) runs on small fixtures — one tripping and one clean
snippet per rule — so a rule that stops firing (or starts over-firing)
fails here before it silently weakens the gate, as the reference's
``tests/test_analysis.py`` holds its rules.  The gate then runs on
``src/repro_torch`` and must be clean modulo the package's baseline, with
the reference gate's exit codes (0 clean, 1 findings, 2 usage).  Layer 2
builds the UQ1 engines: no collective in the unsharded engine, the same
Philox position after one call of the device and of the host loop, the
sharded loops' collectives per round (world 1 here, world 2 in two gloo
ranks), and one static buffer set per capacity class.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis.findings import Baseline, Finding
from repro_torch.analysis.lint import load_tree, run_lint
from repro_torch.analysis.rules.capture_sync import CaptureSyncRule
from repro_torch.analysis.rules.nondeterminism import NondeterminismRule

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")


def _lint_snippet(tmp_path, source, name="snippet.py", prefix=None,
                  rule=None):
    """Lint one fixture file (``rule``: that rule only; a fixture named as
    the engine's module would otherwise also meet ``stats-width``'s
    project check)."""
    p = tmp_path / name
    p.write_text(textwrap.dedent(source))
    prefixes = [prefix] if prefix is not None else None
    return run_lint([str(p)], rel_prefixes=prefixes,
                    rules=None if rule is None else [rule])


def _rules(findings):
    return sorted({f.rule for f in findings})


def _gate(*args, timeout=120, env=None):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, PYTHONPATH=SRC, **(env or {})))


# -- layer 1: the captured context and its rules ------------------------------

CAPTURED = """
    import torch

    def _helper(t):
        return t.sum().item()

    class TorchUnionSampler:
        def _round_step(self, cb):
            self._round_core(cb.total)
            return _helper(cb.total)

        def _round_core(self, owed):
            if owed > 0:
                owed = owed - 1
            return int(owed) + float(torch.ones(1))

        def _sync(self, cb):
            return cb.ctr.tolist()          # the loop's sync: not captured

    # analysis: captured
    def marked(x):
        torch.cuda.synchronize()
        return x.cpu()
"""


def test_capture_sync_fires_in_the_captured_context_only(tmp_path):
    eng = "torch_backend.py"
    bad = _lint_snippet(tmp_path, CAPTURED, eng, prefix="core/backends",
                        rule=CaptureSyncRule())
    assert {f.path for f in bad} == {"core/backends/torch_backend.py"}
    mod = load_tree(str(tmp_path / eng), "core/backends")[0]
    # a round entry by name in the engine's module, what it calls in the
    # same module, and a marked function
    captured = {mod.qualname(f) for f in mod.defs
                if id(f) in mod.captured_functions()}
    assert captured == {"_helper", "TorchUnionSampler._round_step",
                        "TorchUnionSampler._round_core", "marked"}
    assert _rules(bad) == ["capture-sync"]
    assert sorted(f.detail for f in bad) == sorted(
        ["item", "if:owed", "int:owed", "float:torch.ones",
         "torch.cuda.synchronize", "cpu"])
    # the same round entries in another module are not the engine's
    assert _lint_snippet(tmp_path, CAPTURED.replace(
        "    # analysis: captured\n", ""), eng, prefix="launch",
        rule=CaptureSyncRule()) == []

    clean = _lint_snippet(tmp_path, """
        from typing import Optional, Tuple
        import torch

        class TorchUnionSampler:
            def _round_step(self, cb, n: int, w: Optional[int],
                            attrs: Tuple[str, ...]):
                if w is not None and cb.out.shape[0] == n and attrs:
                    return int(sum(self.piece_batches)) + cb.total
                return torch.where(cb.total < n, cb.total, 0)
    """, eng, prefix="core/backends", rule=CaptureSyncRule())
    assert clean == []


def test_estimator_pull_rule(tmp_path):
    bad = _lint_snippet(tmp_path, """
        class Online:
            def _score(self, name):
                st = self.estimator.size_stats[name]
                return st.mean * st.count

            def sample(self, n):
                return [self._score(j) for j in range(n)]
    """)
    assert _rules(bad) == ["estimator-pull"]

    clean = _lint_snippet(tmp_path, """
        class Online:
            def _refresh_size_cache(self):
                out = {}
                for name, st in self.estimator.size_stats.items():
                    out[name] = st.mean * st.count
                self._cache = out

            def sample(self, n):
                return [self._cache for _ in range(n)]
    """)
    assert clean == []


def test_fixed_point_rule_fires_on_marked_functions_only(tmp_path):
    bad = _lint_snippet(tmp_path, """
        def budget(a, b):  # analysis: fixed-point
            return a * 0.5 + b / 2
    """)
    assert _rules(bad) == ["f64-in-planner"] and len(bad) == 2

    clean = _lint_snippet(tmp_path, """
        def budget(a, b):  # analysis: fixed-point
            return (a >> 1) + b // 2

        def unmarked(a):
            return a * 0.5
    """)
    assert clean == []


def test_nondeterminism_rule(tmp_path):
    bad = _lint_snippet(tmp_path, """
        import time
        import torch

        class TorchUnionSampler:
            def _round_step(self, cb):
                u = torch.rand(4)
                return u + time.time()
    """, "torch_backend.py", prefix="core/backends",
                        rule=NondeterminismRule())
    assert _rules(bad) == ["nondeterminism"]
    assert sorted(f.detail for f in bad) == ["time.time",
                                             "torch.rand:no-generator"]
    clean = _lint_snippet(tmp_path, """
        import torch

        class TorchUnionSampler:
            def _round_step(self, cb):
                return torch.rand(4, generator=self.gen)

        def host(x):
            return torch.rand(4)
    """, "torch_backend.py", prefix="core/backends",
                          rule=NondeterminismRule())
    assert clean == []


def test_int32_packing_rule_scoped_to_core(tmp_path):
    src = """
        import numpy as np

        def pack(cols, widths):
            key = np.zeros(4, np.int32)
            for c, w in zip(cols, widths):
                key = key * w + c
            return key
    """
    assert _rules(_lint_snippet(tmp_path, src, prefix="core")) \
        == ["int32-overflow"]
    assert _lint_snippet(tmp_path, src, prefix="launch") == []
    guarded = src + "        _I32_LIM = 1 << 31\n"
    assert _lint_snippet(tmp_path, guarded, prefix="core") == []


def test_stats_width_rule(tmp_path):
    root = tmp_path / "pkg"
    (root / "core" / "backends").mkdir(parents=True)
    (root / "core" / "union_sampler.py").write_text(textwrap.dedent("""
        import dataclasses

        @dataclasses.dataclass
        class SamplerStats:
            iterations: int = 0
            candidate_draws: int = 0
    """))
    canon = root / "core" / "backends" / "torch_backend.py"
    canon.write_text(textwrap.dedent("""
        import torch
        _STAT_FIELDS = ("iterations", "candidate_draws")
        PIECE_STAT_FIELDS = ("draws",)

        def step(a, b):
            stats = torch.stack([a, b])
            return stats
    """))
    assert run_lint([str(root)]) == []
    canon.write_text(canon.read_text().replace(
        "torch.stack([a, b])", "torch.stack([a, b, a])").replace(
        '"candidate_draws")', '"candidate_draws", "renamed")'))
    (root / "core" / "shadow.py").write_text(
        "PIECE_STAT_FIELDS = ('draws',)\n")
    found = run_lint([str(root)])
    assert _rules(found) == ["stats-width"]
    assert sorted(f.detail for f in found) == [
        "field:renamed", "shadow:PIECE_STAT_FIELDS"]
    canon.write_text(canon.read_text().replace(
        '"candidate_draws", "renamed")', '"candidate_draws")'))
    assert [f.detail for f in run_lint([str(root)])
            if f.detail.startswith("width")] == ["width:stats:3"]


def test_missing_fallback_rule(tmp_path):
    bad = _lint_snippet(tmp_path, """
        import warnings

        def pick(kind):
            if kind != "torch":
                warnings.warn("no device engine; falling back to host")
            return kind
    """)
    assert _rules(bad) == ["missing-fallback"]

    clean = _lint_snippet(tmp_path, """
        import warnings
        from repro_torch import obs

        def pick(kind):
            if kind != "torch":
                warnings.warn("no device engine; falling back to host")
                obs.record_fallback("backend", detail=kind)
            return kind
    """)
    assert clean == []


def test_lock_discipline_rule(tmp_path):
    bad = _lint_snippet(tmp_path, """
        import threading

        class Service:
            def __init__(self):
                self._lock = threading.Lock()
                self._cursor = 0
                self._q = None

            def request(self):
                with self._lock:
                    self._cursor += 1
                    return self._q.get()

            def reset(self):
                self._cursor = 0
    """)
    assert _rules(bad) == ["lock-discipline"] and len(bad) == 2

    clean = _lint_snippet(tmp_path, """
        import threading

        class Service:
            def __init__(self):
                self._lock = threading.Lock()
                self._cursor = 0
                self._q = None

            def request(self):
                with self._lock:
                    self._cursor += 1
                return self._q.get(timeout=1.0)

            def reset(self):
                with self._lock:
                    self._cursor = 0
    """)
    assert clean == []


def test_inline_allow_suppresses(tmp_path):
    clean = _lint_snippet(tmp_path, """
        class TorchUnionSampler:
            def _round_step(self, cb):
                return cb.total.item()  # analysis: allow(capture-sync)
    """, "torch_backend.py", prefix="core/backends", rule=CaptureSyncRule())
    assert clean == []


# -- fingerprints, baseline and the gate --------------------------------------

def test_fingerprint_ignores_line_numbers():
    a = Finding("r", "p.py", 10, "f", "msg", detail="tok")
    b = Finding("r", "p.py", 99, "f", "other msg", detail="tok")
    assert a.fingerprint == b.fingerprint


def test_baseline_split_stale_and_reason(tmp_path):
    f1 = Finding("r", "p.py", 1, "f", "m", detail="one")
    f2 = Finding("r", "p.py", 2, "g", "m", detail="two")
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"findings": [
        {"fingerprint": f1.fingerprint, "reason": "known, accepted"},
        {"fingerprint": "deadbeefdeadbeef", "reason": "gone"},
    ]}))
    base = Baseline.load(str(bl))
    active, suppressed = base.split([f1, f2])
    assert active == [f2] and suppressed == [f1]
    assert base.stale([f1, f2]) == ["deadbeefdeadbeef"]
    bl.write_text(json.dumps({"findings": [{"fingerprint": "abc"}]}))
    with pytest.raises(ValueError):
        Baseline.load(str(bl))


def test_gate_exit_codes(tmp_path):
    p = tmp_path / "seeded.py"
    p.write_text(textwrap.dedent("""
        # analysis: captured
        def f(x):
            if x > 0:
                return float(x)
            return x.item()
    """))
    proc = _gate("--layers", "ast", "--baseline", "", str(p), "--json")
    assert proc.returncode == 1, proc.stdout + proc.stderr
    out = json.loads(proc.stdout)
    assert {f["rule"] for f in out["findings"]} == {"capture-sync"}
    assert len(out["findings"]) == 3
    # the same finding baselined: clean, and the entry is not stale
    bl = tmp_path / "bl.json"
    bl.write_text(json.dumps({"findings": [
        {"fingerprint": f["fingerprint"], "reason": "fixture"}
        for f in out["findings"]]}))
    assert _gate("--layers", "ast", "--baseline", str(bl),
                 str(p)).returncode == 0
    assert _gate("--layers", "jaxpr").returncode == 2
    # the audit layers run on the card unless --device cpu: no card, exit 2
    nocard = _gate("--layers", "recompile", env={"CUDA_VISIBLE_DEVICES": ""})
    assert nocard.returncode == 2 and "CUDA" in nocard.stderr
    assert _gate("--no-such-flag").returncode == 2
    assert _gate("--layers", "ast", "--baseline",
                 str(tmp_path / "missing.json")).returncode == 2


def test_gate_self_run_is_clean_modulo_baseline(tmp_path):
    stats = tmp_path / "stats.json"
    proc = _gate("--layers", "ast", "--stats", str(stats))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads(stats.read_text())
    assert data["active"] == 0 and data["stale_baseline"] == 0
    # the package's baseline is empty: every entry would need its reason
    from repro_torch.analysis.__main__ import DEFAULT_BASELINE
    assert Baseline.load(DEFAULT_BASELINE).entries == {}
    listed = _gate("--list-rules").stdout.split()
    for rule in ("capture-sync", "estimator-pull", "f64-in-planner",
                 "nondeterminism", "int32-overflow", "stats-width",
                 "missing-fallback", "lock-discipline"):
        assert rule in listed


def test_port_tree_marks_and_captures_what_it_should():
    """The fixed-point markers sit on the planner's two integer functions,
    and the captured context reaches the rounds' same-module helpers."""
    mods = {m.rel: m for m in load_tree(os.path.join(SRC, "repro_torch"),
                                        "repro_torch")}
    plan = mods["repro_torch/core/planner.py"]
    assert sorted(f.name for f in plan.defs
                  if plan.has_marker(f, "fixed-point")) == [
        "budget_for", "ema_update"]
    eng = mods["repro_torch/core/backends/torch_backend.py"]
    names = {eng.qualname(f) for f in eng.defs
             if id(f) in eng.captured_functions()}
    assert {"TorchUnionSampler._round_core", "TorchUnionSampler._round_step",
            "_emit_and_bank", "_cover_cum"} <= names
    assert "TorchUnionSampler._sync" not in names
    shard = mods["repro_torch/core/sharding/sampler.py"]
    names = {shard.qualname(f) for f in shard.defs
             if id(f) in shard.captured_functions()}
    assert {"ShardedUnionSampler._shard_step",
            "ShardedUnionSampler._local_round",
            "ShardedUnionSampler._exchange_probes"} <= names


# -- layer 2: the audits on the real engines ----------------------------------

def test_trace_audit_unsharded_and_world1():
    from repro_torch.analysis.trace_audit import (audit_sharded,
                                                  audit_unsharded)
    findings, report = audit_unsharded("uq1", "static", "uq1-static",
                                       round_batch=1024, device="cpu")
    assert findings == [], [f.render() for f in findings]
    assert report["collectives"] == [] and report["same_stream_position"]
    findings, report = audit_sharded(1, "uq1-sharded-w1", device="cpu")
    assert findings == [], [f.render() for f in findings]
    assert report["collectives"] == report["host_collectives"] == []


def test_trace_audit_sharded_world2():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_mesh_support import spawn
    spawn("trace_audit_ranks", 2, 120.0)


def test_recompile_audit_one_buffer_set_per_capacity_class(monkeypatch):
    import torch

    from repro_torch.analysis.recompile import audit_recompile_engine
    from repro_torch.analysis.trace_audit import build_engine
    # the audits' engines are on the card unless the CPU is asked for
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        build_engine(workload="uq1", plan="static")
    eng = build_engine(workload="uq1", plan="static", round_batch=1024,
                       device="cpu")
    findings, report = audit_recompile_engine(eng, "uq1-static")
    assert findings == [], [f.render() for f in findings]
    assert report["capacity_classes"] == report["buffers"] == [1024, 2048]
    assert report["graphs"] is False and report["captures"] == 0
