"""Device resolution for the port's entry points.

Every entry point takes an explicit ``device``.  ``None`` means the card:
the port never falls back to the CPU on its own, so a missing card is an
error unless the caller asked for ``"cpu"``.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; raise when CUDA is asked for and unavailable."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: CUDA device requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"repro_torch: unsupported device {dev}")
    return dev


def rank_device(device=None) -> torch.device:
    """The device of this rank: ``device=None`` is the card indexed by
    ``LOCAL_RANK`` (torchrun's) modulo the visible cards; it raises without
    a card unless ``device="cpu"``."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                           % torch.cuda.device_count())
    return dev


def mesh_device(mesh, device=None):
    """The device of an entry point called with ``mesh=``: the mesh's
    rank device, which ``device`` may repeat but not contradict.  Without a
    mesh, ``device`` as given."""
    if mesh is None:
        return device
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"device={device!r} differs from the mesh's device "
                         f"{mesh.device}")
    return mesh.device
