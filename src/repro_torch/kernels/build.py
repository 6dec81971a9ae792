"""Build and load the port's CUDA kernels (nvcc + ctypes).

``load()`` compiles ``csrc/probe.cu`` on first use into a shared library with
a plain C interface, caches it by the hash of the source and the flags under
``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``), and loads it with :mod:`ctypes`.  Only the repository's own
sources are compiled; no PyTorch header is included, so a build takes
seconds.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = ("probe.cu",)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

# argtypes of every exported C function: pointers and the stream are
# c_void_p, sizes c_longlong; each returns cudaGetLastError() as an int
_P, _N = ctypes.c_void_p, ctypes.c_longlong
_SIGNATURES = {
    "repro_sorted_probe_i32": (_P, _N, _P, _N, _P, _P, _P),
    "repro_sorted_probe_i64": (_P, _N, _P, _N, _P, _P, _P),
    "repro_probe_pick_i32": (_P, _N, _P, _P, _N, _P, _P, _P),
    "repro_probe_pick_i64": (_P, _N, _P, _P, _N, _P, _P, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise RuntimeError("repro_torch kernels: nvcc not found (needs the CUDA "
                       "toolkit on PATH or under /usr/local/cuda)")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libprobe_{_digest()}.so"


def build() -> Dict[str, object]:
    """Compile the library if its cached copy is missing.

    Returns ``{"path", "seconds", "cached", "log"}``; ``log`` is nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills per kernel).
    Raises with nvcc's output when the compile fails."""
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(out), "seconds": 0.0, "cached": True, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    log = proc.stdout + proc.stderr
    log_path.write_text(log)
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "cached": False, "log": log}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with every function's argtypes/restype declared
    (built on first call; one handle per process)."""
    lib = ctypes.CDLL(build()["path"])
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
