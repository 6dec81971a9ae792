#!/usr/bin/env python3
"""Time variants of the sorted-probe and segdegree kernels on the card.

Builds copies of ``src/repro_torch/kernels/csrc/probe.cu`` that differ only
in the lanes per query of ``sorted_probe`` (``kGroup`` = 8, 16, 32), and
copies of ``csrc/segdegree.cu`` that differ only in the least keys per CTA
(``kMinCtaKeys``) and the 16-byte loads per lane in flight (``kUnroll``),
one ``nvcc`` each, all started together, into a temporary directory under
``build/``.  Then it builds UQ1 at scale 100 on the card and calls each
library's C launcher on the inputs of ``chip_smoke.py``: ``sorted_probe``
on UQ1_J0's orders and lineitem indexes, each with one piece batch of real
queries; ``segdegree`` on the lineitem index (int32), on 60,000,000 TPC-H
SF 10 ``l_orderkey`` values (int64) and on an all-equal column of the same
size.  Each result is checked against the plain version, and the variants
are timed in turns (every variant, then every variant in reverse order,
twice)::

    python3 scripts/kernel_variants.py [--scale 100]

Prints one line per variant and a JSON object; needs one NVIDIA card and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# name -> (source, {line in the source: its replacement})
VARIANTS = {
    **{f"probe_G{g}": ("probe.cu", {
        "constexpr int kGroup = 16;": f"constexpr int kGroup = {g};"})
       for g in (8, 16, 32)},
    **{f"segdegree_min{m}_unroll{u}": ("segdegree.cu", {
        "constexpr long long kMinCtaKeys = 2048;":
            f"constexpr long long kMinCtaKeys = {m};",
        "constexpr int kUnroll = 4;": f"constexpr int kUnroll = {u};"})
       for m, u in ((2048, 4), (2048, 8), (8192, 4), (8192, 8), (32768, 8))},
}


def _build(tmp: pathlib.Path) -> dict:
    """One shared library per variant; returns {name: (lib, ptxas stats)}."""
    import chip_smoke as cs
    from repro_torch.kernels import build
    procs = {}
    for name, (source, edits) in VARIANTS.items():
        text = (build.CSRC / source).read_text()
        for old, new in edits.items():
            if old not in text:
                raise AssertionError(f"{source} no longer holds {old!r}")
            text = text.replace(old, new)
        src = tmp / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(tmp / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        prefix = name.split("_")[0]
        for fn, (restype, argtypes) in build._SIGNATURES.items():
            if fn.startswith("repro_sorted_probe" if prefix == "probe"
                             else "repro_segdegree"):
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
        kernel = ("sorted_probe_kernel" if prefix == "probe"
                  else "segdegree_kernel")
        out[name] = (lib, {"int32": cs._ptxas_stats(log, kernel, "kernelIiE"),
                           "int64": cs._ptxas_stats(log, kernel, "kernelIlE")})
    return out


def _probe(lib, keys, q):
    """sorted_probe's wrapper steps on this library: allocate, launch."""
    import torch
    lo = torch.empty(q.numel(), dtype=torch.int32, device="cuda")
    hi = torch.empty_like(lo)
    sym = ("repro_sorted_probe_i32" if keys.dtype == torch.int32
           else "repro_sorted_probe_i64")
    rc = getattr(lib, sym)(keys.data_ptr(), keys.numel(), q.data_ptr(),
                           q.numel(), lo.data_ptr(), hi.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    if rc < 0:
        raise RuntimeError(f"launch failed with CUDA error {-rc}")
    return lo, hi


def _segdegree(lib, keys):
    """segdegree's wrapper steps on this library: wave, scratch, launch,
    fetch."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    wave = lib.repro_segdegree_wave(keys.element_size(), sms)
    n = lib.repro_segdegree_scratch_bytes(wave)
    scratch = torch.empty(n, dtype=torch.uint8, device="cuda")
    out = torch.empty(2, dtype=torch.int64, device="cuda")
    sym = ("repro_segdegree_i32" if keys.dtype == torch.int32
           else "repro_segdegree_i64")
    rc = getattr(lib, sym)(keys.data_ptr(), keys.numel(), wave,
                           scratch.data_ptr(), n, out.data_ptr(),
                           torch.cuda.current_stream().cuda_stream)
    if rc < 0:
        raise RuntimeError(f"launch failed with CUDA error {-rc}")
    return tuple(out.tolist())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=float, default=100.0,
                    help="UQ1 scale (100 ≈ TPC-H SF 1)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import probe, segdegree
    from repro_torch.launch.serve import build_sampler
    sampler = build_sampler("UQ1", args.scale, seed=0, device="cuda",
                            round_batch=8192)[0]
    tree = sampler.backend.trees[sampler.order[0]]
    batch = sampler.engine.piece_batches[0]
    weighted = [i for i, c in enumerate(tree.node_cfgs)
                if c.kind == "tree" and not c.uniform]
    uniform = [i for i, c in enumerate(tree.node_cfgs) if c.uniform]
    probes = {}
    for label, pool in (("orders", weighted), ("lineitem", uniform)):
        i = max(pool, key=lambda i: tree.sorted_keys[i].numel())
        probes[label] = (tree.sorted_keys[i], cs._node_queries(tree, i, batch))
    big = cs._lineitem_orderkeys(cs.SF10_LINES, 0)
    columns = {"lineitem": probes["lineitem"][0], "sf10": big,
               "all_equal": torch.full_like(big, cs.I64_MAX)}
    want = {label: segdegree.segdegree_plain(c) for label, c in columns.items()}
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=ROOT / "build"))
    try:
        libs = _build(tmp)
        res = {}
        order = list(libs)
        for name in (order + order[::-1]) * 2:
            lib, stats = libs[name]
            r = res.setdefault(name, {"ptxas": stats})
            if name.startswith("probe"):
                g = lib.repro_sorted_probe_group()
                r["G"] = g
                for label, (keys, q) in probes.items():
                    cs._check_equal(_probe(lib, keys, q),
                                    probe.sorted_probe_plain(keys, q),
                                    f"{name} at {label}")
                    r[f"{label}_levels"] = cs._search_levels(keys.numel(), g)
                    r.setdefault(f"{label}_ms", []).append(
                        cs._device_ms(lambda: _probe(lib, keys, q)))
            else:
                for label, col in columns.items():
                    got = _segdegree(lib, col)
                    if got != want[label]:
                        raise AssertionError(f"{name} at {label}: {got} != "
                                             f"{want[label]}")
                    r.setdefault(f"{label}_ms", []).append(cs._device_ms(
                        lambda: _segdegree(lib, col),
                        reps=100 if label == "lineitem" else 30))
        inputs = {**{f"probe_{label}": {"n_keys": k.numel(),
                                        "n_queries": q.numel(),
                                        "dtype": str(k.dtype)}
                     for label, (k, q) in probes.items()},
                  **{f"segdegree_{label}": {"n_keys": c.numel(),
                                            "dtype": str(c.dtype)}
                     for label, c in columns.items()}}
        for name, r in res.items():
            print(f"{name}: {json.dumps(r)}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"card: {cs._card_line()}", flush=True)
    print(json.dumps({"kernel_variants": res, "inputs": inputs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
