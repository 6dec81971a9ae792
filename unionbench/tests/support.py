"""Shared helpers of the harness's CPU tests: a copy of the benchmark's
files with every configuration cut to a size the CPU runs in a second."""

from __future__ import annotations

import json
import pathlib
import shutil

ROOT = pathlib.Path(__file__).resolve().parents[2]
PKG = ROOT / "unionbench"
SEED = 3_000_000_017            # above 2**31: seeds may exceed 32 signed bits

# tiny scale factors at which every UQ1 piece still has tuples
SCALES = {"uq1": {"sf": 0.001, "overlap": 0.4},
          "uq2": {"sf": 0.005}}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_copy(tmp: pathlib.Path) -> pathlib.Path:
    """The benchmark's files under ``tmp/unionbench`` with tiny configs and
    a short warm phase."""
    pkg = tmp / "unionbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    for p in (pkg / "configs").glob("*.json"):
        cfg = json.loads(p.read_text())
        cfg.update(SCALES[cfg["workload"]])
        if cfg["warmup"]["method"] == "random_walk":
            cfg["warmup"]["rw_max_walks"] = 2048
        p.write_text(json.dumps(cfg))
    for p in (pkg / "traffic").glob("*.json"):
        mix = json.loads(p.read_text())
        if "warm_s" in mix:
            mix["warm_s"] = 0.1
        p.write_text(json.dumps(mix))
    return pkg


def with_online(b: dict) -> dict:
    """``b`` with the Algorithm-2 cell, whether or not it is listed."""
    if not any(w["traffic"] == "online-grow" for w in b["workloads"]):
        b["workloads"].append({"name": "uq1-sf1.online", "config": "uq1-sf1",
                               "traffic": "online-grow", "chips": 1,
                               "why": "test"})
    return b
