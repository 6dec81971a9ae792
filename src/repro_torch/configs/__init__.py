"""Architecture registry: --arch <id> -> ModelConfig (+ reduced smoke config).

The port's copy of the reference's registry (``repro/configs``), field for
field: the 10 assigned architectures + the paper-native unionlm config.  Shape cells
(train_4k / prefill_32k / decode_32k / long_500k) are defined here too so the
dry-run, benchmarks, and tests agree on one source of truth.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..models.transformer import ModelConfig
from . import (arctic_480b, gemma2_9b, granite_20b, mamba2_780m,
               minitron_8b, mistral_large_123b, paligemma_3b, phi35_moe,
               unionlm_100m, whisper_medium, zamba2_7b)

_MODULES = {
    "minitron-8b": minitron_8b,
    "granite-20b": granite_20b,
    "gemma2-9b": gemma2_9b,
    "mistral-large-123b": mistral_large_123b,
    "mamba2-780m": mamba2_780m,
    "zamba2-7b": zamba2_7b,
    "whisper-medium": whisper_medium,
    "phi3.5-moe-42b-a6.6b": phi35_moe,
    "arctic-480b": arctic_480b,
    "paligemma-3b": paligemma_3b,
    "unionlm-100m": unionlm_100m,
}

ASSIGNED_ARCHS: List[str] = [k for k in _MODULES if k != "unionlm-100m"]


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str          # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].smoke_config()


def cell_runnable(arch: str, shape: str) -> Tuple[bool, str]:
    """Skip policy (DESIGN.md §4): long_500k only for sub-quadratic archs."""
    cfg = get_config(arch)
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("pure full-attention arch: every layer would need the "
                       "full 500K dense-attention KV (documented skip)")
    return True, ""


def all_cells() -> List[Tuple[str, str, bool, str]]:
    out = []
    for arch in ASSIGNED_ARCHS:
        for shape in SHAPES:
            ok, why = cell_runnable(arch, shape)
            out.append((arch, shape, ok, why))
    return out
