#!/usr/bin/env python3
"""Time variants of the probe and segdegree kernels on the card.

Builds copies of ``src/repro_torch/kernels/csrc/probe.cu`` that differ only
in the lanes per query of one probe kernel (``kSortedProbeGroup`` or
``kProbePickGroup`` = 8, 16, 32), and copies of ``csrc/segdegree.cu`` that
differ only in the least keys per CTA (``kMinCtaKeys``) and the 16-byte
loads per lane in flight (``kUnroll``), one ``nvcc`` each, all started
together, into a temporary directory under ``build/``.  Then it builds UQ1
and UQ4 on the card at ``chip_smoke.py``'s full scales (``UQ1_SCALE``,
``UQ4_SCALE``) and calls each library's C launcher on the inputs of
``chip_smoke.py``: ``sorted_probe`` on UQ1_J0's
orders and lineitem indexes, ``probe_pick`` on the lineitem index and on
UQ4's residual index, each with one piece batch of real queries;
``segdegree`` on the lineitem index (int32), on 60,000,000 TPC-H SF 10
``l_orderkey`` values (int64) and on an all-equal column of the same size.
Each probe variant is first held against the plain version on every shared
probe case (``cases.PROBE_CASES`` and ``PROBE_CARD_CASES``, with
``cases.probe_uniforms``); every result is checked against the plain
version, and the variants are timed in turns (every variant, then every
variant in reverse order, twice)::

    python3 scripts/kernel_variants.py

Prints one line per variant and a JSON object; needs one NVIDIA card and
``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# name -> (kernel, source, {constant in the source: its value})
VARIANTS = {
    **{f"{k}_G{g}": (k, "probe.cu", {const: g})
       for k, const in (("sorted_probe", "kSortedProbeGroup"),
                        ("probe_pick", "kProbePickGroup"))
       for g in (8, 16, 32)},
    **{f"segdegree_min{m}_unroll{u}": ("segdegree", "segdegree.cu", {
        "kMinCtaKeys": m, "kUnroll": u})
       for m, u in ((2048, 4), (2048, 8), (8192, 4), (8192, 8), (32768, 8))},
}


def _set_constant(text: str, name: str, value: int) -> str:
    """``constexpr <type> name = ...;`` with ``value`` in place of ``...``."""
    new, n = re.subn(rf"(constexpr [\w ]+? {name} = )[^;]+;",
                     rf"\g<1>{value};", text)
    if n != 1:
        raise AssertionError(f"{n} constexpr lines define {name}")
    return new


def _build(tmp: pathlib.Path) -> dict:
    """One shared library per variant; returns {name: (lib, kernel, ptxas
    stats)}."""
    import chip_smoke as cs
    from repro_torch.kernels import build
    procs = {}
    for name, (_, source, consts) in VARIANTS.items():
        text = (build.CSRC / source).read_text()
        for const, value in consts.items():
            text = _set_constant(text, const, value)
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
        kernel, _, consts = VARIANTS[name]
        lib = ctypes.CDLL(str(tmp / f"{name}.so"))
        for fn, (restype, argtypes) in build._SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
        group = None if kernel == "segdegree" else next(iter(consts.values()))
        out[name] = (lib, kernel,
                     cs._ptxas_pair(f"{kernel}_kernel", group, log))
    return out


def _probe(lib, kernel, keys, q, u=None):
    """The probe wrappers' steps on this library: allocate, launch."""
    import torch
    a = torch.empty(q.numel(), dtype=torch.int32, device="cuda")
    b = torch.empty_like(a)
    suffix = "i32" if keys.dtype == torch.int32 else "i64"
    args = (keys.data_ptr(), keys.numel(), q.data_ptr())
    if kernel == "probe_pick":
        args += (u.data_ptr(),)
    rc = getattr(lib, f"repro_{kernel}_{suffix}")(
        *args, q.numel(), a.data_ptr(), b.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc < 0:
        raise RuntimeError(f"launch failed with CUDA error {-rc}")
    return a, b


def _check_cases(lib, kernel, name) -> None:
    """A probe variant against the plain version on every shared case."""
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import probe
    from repro_torch.kernels.cases import (PROBE_CARD_CASES, PROBE_CASES,
                                           key_dtypes, probe_case,
                                           probe_uniforms)
    for case in PROBE_CASES + PROBE_CARD_CASES:
        keys, qs = probe_case(case)
        u = torch.as_tensor(probe_uniforms(case, qs.shape[0]), device="cuda")
        for dt in key_dtypes(keys, qs):
            k = torch.as_tensor(keys, device="cuda").to(dt)
            q = torch.as_tensor(qs, device="cuda").to(dt)
            want = (probe.sorted_probe_plain(k, q) if kernel == "sorted_probe"
                    else probe.probe_pick_plain(k, q, u))
            cs._check_equal(_probe(lib, kernel, k, q, u), want,
                            f"{name} at {case} {dt}")


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import probe, segdegree
    from repro_torch.launch.serve import build_sampler
    sampler = build_sampler("UQ1", cs.UQ1_SCALE, seed=0, device="cuda",
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
    uq4 = build_sampler("UQ4", cs.UQ4_SCALE, seed=0, device="cuda",
                        round_batch=8192)[0]
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    picks = {label: (k, q, torch.rand(q.shape, generator=g, device="cuda"))
             for label, (k, q) in (("lineitem", probes["lineitem"]),
                                   ("residual", cs._residual_inputs(uq4)[1:]))}
    big = cs._lineitem_orderkeys(cs.SF10_LINES, 0)
    columns = {"lineitem": probes["lineitem"][0], "sf10": big,
               "all_equal": torch.full_like(big, cs.I64_MAX)}
    want = {label: segdegree.segdegree_plain(c) for label, c in columns.items()}
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=ROOT / "build"))
    try:
        libs = _build(tmp)
        for name, (lib, kernel, _) in libs.items():
            if kernel != "segdegree":
                _check_cases(lib, kernel, name)
        res = {}
        order = list(libs)
        for name in (order + order[::-1]) * 2:
            lib, kernel, stats = libs[name]
            r = res.setdefault(name, {"ptxas": stats})
            if kernel == "segdegree":
                for label, col in columns.items():
                    got = _segdegree(lib, col)
                    if got != want[label]:
                        raise AssertionError(f"{name} at {label}: {got} != "
                                             f"{want[label]}")
                    r.setdefault(f"{label}_ms", []).append(cs._device_ms(
                        lambda: _segdegree(lib, col),
                        reps=100 if label == "lineitem" else 30))
                continue
            r["G"] = getattr(lib, f"repro_{kernel}_group")()
            by_label = (probes if kernel == "sorted_probe" else
                        {label: (k, q) for label, (k, q, _) in picks.items()})
            for label, (keys, q) in by_label.items():
                u = picks[label][2] if kernel == "probe_pick" else None
                plain = (probe.sorted_probe_plain(keys, q) if u is None
                         else probe.probe_pick_plain(keys, q, u))
                cs._check_equal(_probe(lib, kernel, keys, q, u), plain,
                                f"{name} at {label}")
                r[f"{label}_levels"] = cs._search_levels(keys.numel(), r["G"])
                r.setdefault(f"{label}_ms", []).append(cs._device_ms(
                    lambda: _probe(lib, kernel, keys, q, u)))
        inputs = {**{f"sorted_probe_{label}": {"n_keys": k.numel(),
                                               "n_queries": q.numel(),
                                               "dtype": str(k.dtype)}
                     for label, (k, q) in probes.items()},
                  **{f"probe_pick_{label}": {"n_keys": k.numel(),
                                             "n_queries": q.numel(),
                                             "dtype": str(k.dtype)}
                     for label, (k, q, _) in picks.items()},
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
