#!/usr/bin/env python3
"""Time variants of the decode-attention kernel's pipeline on the card.

Builds copies of ``src/repro_torch/kernels/csrc/attention.cu`` that differ
only in the number of K/V ring stages (``kStages``) and in the CTAs per SM
asked of the compiler (``__launch_bounds__``), one ``nvcc`` each, all
started together, into a temporary directory under ``build/``.  Then it
calls each library's C launcher on gemma-2-9b's widths (bf16, B 8, S 8192,
16 query and 8 KV heads, D 256, softcap 50, lengths in [4096, 8192]; the
inputs of ``chip_smoke.py``'s ``[ops]`` phase), checks the output against
the plain version, and times a global and a local (window 4096) layer in
turns (every variant, then every variant in reverse order, twice)::

    python3 scripts/attention_variants.py

Prints one line per variant and a JSON object; needs one NVIDIA card and
``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import math
import pathlib
import shutil
import subprocess
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# (stages, CTAs per SM asked of the compiler)
VARIANTS = [(2, 2), (3, 2), (4, 1), (2, 3)]


def _source(stages: int, min_ctas: int) -> str:
    from repro_torch.kernels import build
    text = (build.CSRC / "attention.cu").read_text()
    for old, new in (("constexpr int kStages = 2;",
                      f"constexpr int kStages = {stages};"),
                     ("__launch_bounds__(kThreads, 2)",
                      f"__launch_bounds__(kThreads, {min_ctas})")):
        if old not in text:
            raise AssertionError(f"attention.cu no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def _build(tmp: pathlib.Path) -> dict:
    """One shared library per variant; returns {name: (lib, ptxas stats)}."""
    import chip_smoke as cs
    from repro_torch.kernels import build
    procs = {}
    for stages, min_ctas in VARIANTS:
        name = f"stages{stages}_ctas{min_ctas}"
        src = tmp / f"{name}.cu"
        src.write_text(_source(stages, min_ctas))
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
        for fn, (restype, argtypes) in build._SIGNATURES.items():
            if fn.startswith("repro_decode_attention"):
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
        out[name] = (lib, cs._ptxas_stats(log, "decode_attn_kernel",
                                          "13__nv_bfloat16Li256ELi2E"))
    return out


def _call(lib, q, k, v, lens, softcap: float, window: int):
    """The wrapper's steps, on this library: plan the wave, allocate the
    scratch, launch; returns the output."""
    import torch
    B, H, D = q.shape
    S, KVH = k.shape[1], k.shape[2]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ctas = lib.repro_decode_attention_ctas(H, KVH, D, 1, sms)
    n = lib.repro_decode_attention_scratch_bytes(B, H, KVH, D, ctas)
    scratch = torch.empty(n, dtype=torch.uint8, device="cuda")
    out = torch.empty_like(q)
    rc = lib.repro_decode_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(), B, H, S,
        KVH, D, 1.0 / math.sqrt(D), softcap, window, ctas, scratch.data_ptr(),
        n, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc < 0:
        raise RuntimeError(f"launch failed with CUDA error {-rc}")
    return out, ctas


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import attention
    from repro_torch.kernels.cases import attention_tol
    cfg = cs.GEMMA2_9B
    B, S, H, KVH, D = cs.ATTN_BATCH, cs.ATTN_SEQ, cfg["H"], cfg["KVH"], cfg["D"]
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, device="cuda").to(torch.bfloat16)
               for s in ((B, H, D), (B, S, KVH, D), (B, S, KVH, D)))
    lens = torch.randint(S // 2, S + 1, (B,), generator=g,
                         device="cuda").to(torch.int32)
    cap, win = cfg["softcap"], cfg["window"]
    want = attention.decode_attention_plain(q.float(), k.float(), v.float(),
                                            lens, softcap=cap)
    (ROOT / "build").mkdir(exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=ROOT / "build"))
    try:
        libs = _build(tmp)
        res = {}
        names = list(libs)
        for name in (names + names[::-1]) * 2:
            lib, stats = libs[name]
            out, ctas = _call(lib, q, k, v, lens, cap, 0)
            torch.testing.assert_close(out.float(), want,
                                       **attention_tol(torch.bfloat16))
            r = res.setdefault(name, {"ctas": ctas, "ptxas": stats,
                                      "ms": [], "local_ms": []})
            r["ms"].append(cs._device_ms(
                lambda: _call(lib, q, k, v, lens, cap, 0), reps=50))
            r["local_ms"].append(cs._device_ms(
                lambda: _call(lib, q, k, v, lens, cap, win), reps=50))
        for name, r in res.items():
            print(f"{name}: {json.dumps(r)}", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"card: {cs._card_line()}", flush=True)
    print(json.dumps({"attention_variants": res}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
