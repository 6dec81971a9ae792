"""Run one cell of the benchmark once and print its result line.

    python3 unionbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's configuration, traffic mix,
metrics and limits are found by the names in ``BENCHMARK.json``.  Without
a CUDA card, or with fewer cards than the cell asks for, it exits with 2
and prints no result.  The kernel library and every compile cache stay in
fixed directories under ``build/`` inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "unionbench"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    from unionbench import harness
    bench = harness.spec(ROOT)
    entry = harness.cell_entry(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA card(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.execute(bench, args.workload, args.seed, args.seconds,
                             bool(args.trace), torch.device("cuda", 0),
                             t_start=T_START)
    return harness.emit(result)


if __name__ == "__main__":
    sys.exit(main())
