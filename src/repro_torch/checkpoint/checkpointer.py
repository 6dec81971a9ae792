"""Checkpointing with atomic commit, GC and corruption detection.

The port's copy of the reference's ``repro/checkpoint/checkpointer.py``,
with its layout, so either package restores the other's float32 and
integer checkpoints::

    <dir>/step_00000123/
        manifest.json        # step; per leaf: file, shape, dtype, hash
        <leaf-key>.npy       # one file per leaf ("params/blocks.wq" ->
                             # "params__blocks.wq.npy")
        pipeline.json        # sampler/pipeline state (RNG, stats)
    <dir>/LATEST             # atomic pointer (written via rename)

* **atomic**: a checkpoint is staged in ``step_X.tmp`` and ``os.rename``d;
  readers never observe partial state; LATEST is a one-line pointer file
  updated with the same rename trick.
* **restore onto a device**: leaves are loaded on the host and moved to
  ``device`` (the reference's ``jax.device_put``).
* **integrity**: a blake2b hash of each leaf's bytes in the manifest,
  verified on restore (the reference's ``_hash``).

The leaves are copied, written, read and hashed on a pool of threads
(numpy's file I/O and ``hashlib`` release the interpreter lock), one leaf
per task; the manifest keeps the state's order.

The state is a nested dict of tensors (or numpy arrays, Python numbers).
numpy has no bfloat16, so a bf16 tensor is saved as its ``int16`` bit
pattern with ``"dtype": "bfloat16"`` in the manifest and viewed back as
bf16 on restore: the round trip is exact, and its hash is that of the bf16
bytes.  Every other leaf is saved as the numpy array of its value.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

BF16 = "bfloat16"


def _to_numpy(v: Any) -> Tuple[np.ndarray, str]:
    """(array to save, manifest dtype) of one leaf."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        a = t.numpy()
    else:
        a = np.asarray(v)
    return a, str(a.dtype)


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split("/")
        cur = tree
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return tree


def _hash(a: np.ndarray) -> str:
    return hashlib.blake2b(a.tobytes(), digest_size=8).hexdigest()


def _map(fn, items):
    """``[fn(*item) for item in items]`` on a thread pool."""
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as ex:
        return [f.result() for f in [ex.submit(fn, *it) for it in items]]


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Any,
             pipeline_state: Optional[Dict[str, Any]] = None) -> str:
        name = f"step_{step:08d}"
        tmp = os.path.join(self.dir, name + ".tmp")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        def write(k, v):
            a, dtype = _to_numpy(v)
            fn = k.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fn), a)
            return k, {"file": fn, "shape": list(a.shape), "dtype": dtype,
                       "hash": _hash(a)}
        manifest = {"step": step, "leaves": dict(
            _map(write, _flatten(state).items()))}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if pipeline_state is not None:
            with open(os.path.join(tmp, "pipeline.json"), "w") as f:
                json.dump(_jsonify(pipeline_state), f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                       # atomic commit
        self._update_latest(name)
        self._gc()
        return final

    def _update_latest(self, name: str) -> None:
        tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(name)
        os.rename(tmp, os.path.join(self.dir, "LATEST"))

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.dir, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip().split("_")[1])

    def restore(self, step: Optional[int] = None, device=None,
                verify: bool = True) -> Tuple[Any, Optional[Dict[str, Any]]]:
        """Load a checkpoint as a nested dict of tensors on ``device``
        (``None``: the host) and the pipeline state (or ``None``)."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError("no checkpoint found")
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        def read(k, info):
            a = np.load(os.path.join(d, info["file"]))
            if verify and _hash(a) != info["hash"]:
                raise IOError(f"checkpoint corruption in leaf {k!r}")
            t = torch.from_numpy(a)
            if info["dtype"] == BF16:
                t = t.view(torch.bfloat16)
            return k, (t if device is None else t.to(device))
        flat = dict(_map(read, manifest["leaves"].items()))
        pp = None
        pj = os.path.join(d, "pipeline.json")
        if os.path.exists(pj):
            with open(pj) as f:
                pp = json.load(f)
        return _unflatten(flat), pp


def _jsonify(x: Any) -> Any:
    if isinstance(x, dict):
        return {str(k): _jsonify(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonify(v) for v in x]
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x
