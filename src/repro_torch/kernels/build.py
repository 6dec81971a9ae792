"""Build and load the port's CUDA kernels (nvcc + ctypes), and count launches.

``load()`` compiles every ``csrc/*.cu`` on first use into one shared library
with a plain C interface, caches it by the hash of the sources and the flags
under ``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``), and loads it with :mod:`ctypes`.  Only the repository's own
sources are compiled; no PyTorch header is included, so a build takes
seconds.  Nothing here runs when the module is imported.

:func:`launch` is the one place a wrapper launches a kernel: it calls the C
launcher, raises if it reports a CUDA error, and adds the number of kernels
the launcher reports it launched to :data:`launch_counts`.  Inside
:func:`recording` (a CUDA-graph capture) the kernels are only recorded, so
they go to the capture's own counts; the code that replays the graph adds
them to :data:`launch_counts` once per replay.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Dict

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = tuple(sorted(p.name for p in CSRC.glob("*.cu")))
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# -fmad=false: probe_pick's float32 pick must round exactly as the reference's
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

# argtypes of every exported C function: pointers and the stream are
# c_void_p, sizes c_longlong; the launchers return the number of kernels
# they launched, or minus the CUDA error, as an int; the scratch-size
# queries return a c_longlong, the CTA, group and shared-memory queries an
# int
_P, _N, _I, _F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_ATTN = (_P, _P, _P, _P, _N, _N, _N, _N, _N, _F, _F, _N, _I, _P, _N, _P, _P)
_SIGNATURES = {
    "repro_sorted_probe_group": (_I, ()),
    "repro_probe_pick_group": (_I, ()),
    "repro_sorted_probe_i32": (_I, (_P, _N, _P, _N, _P, _P, _P)),
    "repro_sorted_probe_i64": (_I, (_P, _N, _P, _N, _P, _P, _P)),
    "repro_probe_pick_i32": (_I, (_P, _N, _P, _P, _N, _P, _P, _P)),
    "repro_probe_pick_i64": (_I, (_P, _N, _P, _P, _N, _P, _P, _P)),
    "repro_segdegree_wave": (_I, (_I, _I)),
    "repro_segdegree_scratch_bytes": (_N, (_I,)),
    "repro_segdegree_cta_keys": (_N, (_N, _I)),
    "repro_segdegree_i32": (_I, (_P, _N, _I, _P, _N, _P, _P)),
    "repro_segdegree_i64": (_I, (_P, _N, _I, _P, _N, _P, _P)),
    "repro_decode_attention_ctas": (_I, (_N, _N, _N, _I, _I)),
    "repro_decode_attention_smem_bytes": (_I, (_N, _N, _N, _I)),
    "repro_decode_attention_scratch_bytes": (_N, (_N, _N, _N, _N, _I)),
    "repro_decode_attention_f32": (_I, _ATTN),
    "repro_decode_attention_bf16": (_I, _ATTN),
    "repro_member_lookup_params_bytes": (_I, ()),
    "repro_member_lookup": (_I, (_P, _P)),
}

# kernels launched per wrapper since the last reset (the only global state
# of the port); a run shows through these that its path went through them
launch_counts: Dict[str, int] = {"sorted_probe": 0, "probe_pick": 0,
                                 "segdegree": 0, "decode_attention": 0,
                                 "member_lookup": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


# per thread: the counts of a CUDA-graph capture in progress (a kernel
# recorded into a graph launches only when the graph replays, and the code
# that replays it adds it to launch_counts then)
_recording = threading.local()


@contextlib.contextmanager
def recording():
    """Inside the block, this thread's wrapper calls add the kernels they
    record to the yielded dict instead of ``launch_counts``."""
    counts = {k: 0 for k in launch_counts}
    _recording.counts = counts
    try:
        yield counts
    finally:
        _recording.counts = None


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
    return BUILD_DIR / f"librepro_kernels_{_digest()}.so"


def build() -> Dict[str, object]:
    """Compile the library if its cached copy is missing: one nvcc per
    source, all started together, then one link.

    Returns ``{"path", "seconds", "cached", "log"}``; ``log`` is nvcc's
    ``-Xptxas -v`` report (registers, shared memory, spills per kernel).
    Raises with nvcc's output when a compile or the link fails."""
    out = library_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(out), "seconds": 0.0, "cached": True, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        t0 = time.perf_counter()
        objs = [str(tmp / f"{s}.o") for s in SOURCES]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)]
                for s, o in zip(SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [p.communicate()[0] for p in procs]
        link = [_nvcc(), "-shared", "-o", str(tmp / "lib.so"), *objs]
        for cmd, p, text in zip(cmds, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                                   f"{' '.join(cmd)}\n{text}")
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
        seconds = time.perf_counter() - t0
        log = "".join(logs) + proc.stdout + proc.stderr
        log_path.write_text(log)
        os.replace(tmp / "lib.so", out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"path": str(out), "seconds": seconds, "cached": False, "log": log}


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library with every function's argtypes/restype declared
    (built on first call; one handle per process)."""
    lib = ctypes.CDLL(build()["path"])
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def stream(dev) -> int:
    """The current CUDA stream of ``dev`` as an integer handle."""
    return torch.cuda.current_stream(dev).cuda_stream


def launch(kernel: str, symbol: str, *args) -> None:
    """Call the C launcher ``symbol``; raise on a CUDA error, else add the
    kernels it launched to ``launch_counts[kernel]`` (to the capture's
    counts inside :func:`recording`)."""
    rc = getattr(load(), symbol)(*args)
    if rc < 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {-rc}")
    counts = getattr(_recording, "counts", None)
    (launch_counts if counts is None else counts)[kernel] += rc
