"""The control of a cell's comparison: the plain reference put in the
program's place, with every weight, size and cumulative sum it computes
rounded to bfloat16 (``--precision bf16``), judged exactly as a run's
served rows are.  ``--precision f64`` runs the exact reference in the same
place (it has to pass).

    python3 unionbench/control.py --workload <cell> --seeds 1 2 3 [--precision bf16]

For each seed it builds the cell's inputs, draws as many requests as a
run checks (``check_requests`` sizes from the mix's grid, drawn from the
seed), samples them with the reference and prints one JSON line of the
numbers the cell compares.  Runs on the host; no card needed.  Besides
what the judge reads, the reference that the configuration names gives
``sample(n, rng)`` (Algorithm 1: base ids and home pieces) and
``rows_of(ids)`` (the served rows of those ids), and takes
``precision="bf16"``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(bench: dict, cell: str, seed: int, precision: str,
             pkg: pathlib.Path = None) -> dict:
    import numpy as np

    from unionbench import harness, inputs
    from unionbench.sizes import grid
    from unionbench.reference.judge import judge

    pkg = pkg or harness.PKG
    entry = harness.cell_entry(bench, cell)
    config = harness.load_json(pkg / "configs" / f"{entry['config']}.json")
    traffic = harness.load_json(pkg / "traffic" / f"{entry['traffic']}.json")
    limits = harness.load_json(pkg / "checks" / f"{cell}.json")
    t0 = time.perf_counter()
    union = inputs.build(config, seed)
    reference = harness.reference_entry(config)
    exact = reference(union)
    place = exact if precision == "f64" else reference(union, precision)
    rng = np.random.default_rng([seed, 0xC0])
    asked = rng.choice(grid(traffic), traffic.get("check_requests", 1))
    t1 = time.perf_counter()
    ids, home = place.sample(int(asked.sum()), rng)
    t2 = time.perf_counter()
    bounds = np.concatenate([[0], np.cumsum(asked)])
    got = [int(max(0, min(b, ids.shape[0]) - a))
           for a, b in zip(bounds[:-1], bounds[1:])]
    numbers, info = judge(exact, asked, got, exact.rows_of(ids), home,
                          list(limits))
    t3 = time.perf_counter()
    return {"cell": cell, "seed": seed, "precision": precision,
            "numbers": {k: float(v) for k, v in numbers.items()},
            "passes": all(float(v) <= limits[k] for k, v in numbers.items()),
            "info": info, "inputs_s": t1 - t0, "sample_s": t2 - t1,
            "judge_s": t3 - t2}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--precision", choices=("bf16", "f64"), default="bf16")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from unionbench import harness
    bench = harness.spec(ROOT)
    for seed in args.seeds:
        print(json.dumps(readings(bench, args.workload, seed, args.precision),
                         default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
