"""Whole runs of the harness on the CPU at tiny sizes: each driver, a
traced run, a cell made of new files alone, and the import check."""

import json
import subprocess
import sys

import pytest
import torch

from unionbench import harness
from unionbench.tests import shapes, support

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def pkg(tmp_path_factory):
    return support.tiny_copy(tmp_path_factory.mktemp("unionbench"))


@pytest.mark.parametrize("cell", ["uq1-sf1.stream", "uq2-sf1.stream",
                                  "uq1-sf1.online"])
def test_whole_run_of_each_driver(pkg, cell):
    b = support.with_online(support.bench())
    res = harness.execute(b, cell, support.SEED, 0.3, False, CPU, pkg=pkg)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert {"samples_per_s", "setup_s"} <= set(res["metrics"])
    assert res["device"]["platform"] == "cpu"
    assert list(res)[-2] == "checks"        # the compared numbers come last
    for v in res["checks"].values():
        assert v["value"] <= v["limit"]


def test_traced_run_reads_the_counters(pkg):
    res = harness.execute(support.bench(), "uq2-sf1.stream", support.SEED,
                          1.0, True, CPU, pkg=pkg)
    m = res["metrics"]
    assert res["correct"]
    assert m["round.psi"]["value"] > 1.0
    assert m["loop.host_syncs_per_ksample"]["value"] > 0
    assert 0 < m["serve.engine_busy_share"]["value"] <= 100
    assert m["serve.request_p95_ms"]["value"] > 0
    assert m["build.catalog_s"]["value"] > 0
    assert "samples_per_s" not in m        # end-to-end metrics: untraced runs


def _files(pkg):
    return {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}


def test_a_new_cell_needs_new_files_only(tmp_path):
    """A configuration, a traffic mix, a metric and a cell's limits added as
    files of their own, and entries in BENCHMARK.json, make a runnable
    cell; no file of the harness is edited."""
    pkg = support.tiny_copy(tmp_path)
    before = _files(pkg)
    cfg = json.loads((pkg / "configs" / "uq1-sf1.json").read_text())
    cfg.update(name="uq1-half", overlap=0.5)
    (pkg / "configs" / "uq1-half.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "two-fixed.json").write_text(json.dumps(
        {"driver": "stream", "loop": "closed", "clients": 2,
         "sizes": {"law": "fixed", "size": 300, "grid": 4},
         "check_requests": 16}))
    (pkg / "metrics" / "requests_per_s.py").write_text(
        "def read(run):\n    return len(run.window.records) / run.seconds\n")
    (pkg / "checks" / "uq1-half.two-fixed.json").write_text(json.dumps(
        {"request_size_errors": 0, "rows_not_in_home": 0,
         "rows_in_earlier_piece": 0}))
    b = support.bench()
    b["workloads"].append({"name": "uq1-half.two-fixed", "config": "uq1-half",
                           "traffic": "two-fixed", "chips": 1, "why": "test"})
    b["end_to_end"].append({"name": "requests_per_s", "unit": "requests/s",
                            "better": "higher", "bound": 0.1,
                            "source": "host_clock"})
    res = harness.execute(b, "uq1-half.two-fixed", support.SEED, 0.5, False,
                          CPU, pkg=pkg)
    assert res["correct"], res["checks"]
    assert res["metrics"]["requests_per_s"]["value"] > 0
    assert all(p.read_bytes() == v for p, v in before.items())


# a new shape: the union's builder and reference (registered by the test,
# as a later cell adds them under inputs/ and reference/), its warm-up and
# cover, and the numbers its guarantees say are compared
EXACT = {"request_size_errors": 0, "rows_not_in_home": 0,
         "rows_in_earlier_piece": 0, "law_z": 20.0, "dup_z": 20.0}
SHAPES = {
    "branching": ({"sf": 0.002, "warmup": {"method": "exact"},
                   "plan": "static", "round_batch": 8192,
                   "service": {"batch": 8192, "prefetch": 2}},
                  dict(EXACT, union_law_z=20.0)),
    # UQ1's approximate mode: the cover is estimated by random walks, so
    # piece shares are not compared; a draw closes the cycle about once in
    # 25 (TPC-H's uniform nations), so the engine's calls are kept small
    "cyclic": ({"sf": 0.005, "warmup": {
        "method": "random_walk", "rw_batch": 512, "rw_rel_halfwidth": 0.25,
        "rw_max_walks": 2048}, "plan": "adaptive", "round_batch": 2048,
        "service": {"batch": 1024, "prefetch": 2},
        "joins": [{"name": "Q5_J0"}, {"name": "Q5_J1"}, {"name": "Q5_J2"}]},
        EXACT),
}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_a_new_shape_needs_new_files_only(tmp_path, monkeypatch, shape):
    """A branching (UQ3-style vertical split) and a cyclic (TPC-H Q5's
    graph, a residual (suppkey, nationkey) index) union, each a builder and
    a brute-force reference with new files of their own, run through the
    harness and come out correct; no file of the harness is edited."""
    monkeypatch.setitem(sys.modules, "unionbench.inputs.tiny_shapes", shapes)
    monkeypatch.setitem(sys.modules, "unionbench.reference.brute_union", shapes)
    pkg = support.tiny_copy(tmp_path)
    before = _files(pkg)
    extra, checks = SHAPES[shape]
    cfg = dict(name=f"tiny-{shape}", workload="tiny_shapes",
               reference="brute_union", shape=shape, overlap=0.4,
               fused_rounds="device", **extra)
    (pkg / "configs" / f"tiny-{shape}.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "small.json").write_text(json.dumps(
        {"driver": "stream", "loop": "closed", "clients": 1,
         "sizes": {"law": "fixed", "size": 512, "grid": 1},
         "check_requests": 32, "warm_s": 0.1}))
    cell = f"tiny-{shape}.small"
    (pkg / "checks" / f"{cell}.json").write_text(json.dumps(checks))
    b = support.bench()
    b["workloads"].append({"name": cell, "config": f"tiny-{shape}",
                           "traffic": "small", "chips": 1, "why": "test"})
    res = harness.execute(b, cell, support.SEED, 0.5, False, CPU, pkg=pkg)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(checks)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert all(p.read_bytes() == v for p, v in before.items())


def test_import_check_compares_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.core",
                                      "unionbench", "numpy"]) == []
    assert harness.forbidden_modules(["repro.data.tpch", "repro_torch"]) == ["repro"]
    assert harness.forbidden_modules(["jax.numpy", "flax", "jaxlib"]) == [
        "flax", "jax", "jaxlib"]


RUN = """
import json, pathlib, sys, torch
sys.path[:0] = [{src!r}, {root!r}]
from unionbench import harness
from unionbench.tests import support
{extra}
res = harness.execute(support.bench(), "uq2-sf1.stream", support.SEED, 0.3,
                      False, torch.device("cpu"), pkg=pathlib.Path({pkg!r}))
sys.exit(harness.emit(res))
"""


@pytest.mark.parametrize("extra,code", [
    ("", 0), ("sys.modules['repro'] = type(sys)('repro')", 3)])
def test_a_run_loads_no_jax_and_no_reference_package(pkg, extra, code):
    """In a fresh process a run loads neither JAX nor the JAX package; one
    that has a module named ``repro`` loaded exits 3 and prints no
    result."""
    src = str(support.ROOT / "src")
    p = subprocess.run([sys.executable, "-c", RUN.format(
        src=src, root=str(support.ROOT), pkg=str(pkg), extra=extra)],
        capture_output=True, text=True, timeout=120)
    assert p.returncode == code, p.stderr[-2000:]
    lines = p.stdout.strip().splitlines()
    if code == 0:
        res = json.loads(lines[-1])
        assert res["correct"] and list(res)[-1] == "checks"
    else:
        assert not lines and "forbidden modules loaded: ['repro']" in p.stderr
