"""Model meshes of the port on ``torch.distributed``: the counterpart of the
reference's ``repro/launch/mesh.py``.

Single pod: (16, 16) = ("data", "model"), 256 ranks.  Multi-pod: (2, 16,
16) = ("pod", "data", "model"), 512 ranks.  The "pod" axis composes with
"data" for DP + FSDP, so TP/EP ("model") traffic stays inside a pod; across
pods moves only the gradient reduction (and the int8 variant,
:func:`repro_torch.train.grad_compress.compressed_psum`).

* :func:`make_mesh` is a ``torch.distributed.device_mesh.DeviceMesh`` with
  ``mesh_dim_names``, the ranks of the initialised process group laid out
  row-major, as ``jax.make_mesh`` lays out devices.  It needs a process
  group of exactly ``prod(shape)`` ranks, a world of one included (a
  one-rank group over a ``HashStore`` costs nothing), as the sampler mesh
  (``repro_torch.core.sharding.make_sampler_mesh``) needs one at world >
  1; under NCCL each rank takes the card of
  :func:`repro_torch.device.rank_device`, the sampler mesh's convention.
* :class:`AbstractMesh` describes a mesh by its axis names and sizes with
  no process behind it (JAX's ``AbstractMesh``): the production meshes
  cannot be built on one machine, but their shardings
  (:mod:`repro_torch.launch.sharding`) are computed from this description.
  Every helper here takes either kind.
* :func:`set_mesh` is a context manager that holds the ambient mesh of
  this thread; :func:`ambient_mesh` returns it, or ``None``.
* ``shard_map`` has no counterpart: code that the reference runs under
  ``shard_map`` is per-rank code over the mesh's process groups
  (:func:`axis_group`, the ``mesh.get_group("model")`` of one axis) and
  the rank's coordinates (:func:`axis_index`, ``jax.lax.axis_index``), as
  :func:`repro_torch.models.moe.moe_ffn_dist` is.
* ``cost_analysis_dict`` reads XLA's cost analysis of a compiled program
  and has no counterpart: the dry-run (:mod:`repro_torch.launch.dryrun`)
  compiles nothing, counts a traced step instead
  (:mod:`repro_torch.launch.hlo_census`), and reports XLA's own figures
  (``cost_raw``, ``temp_bytes``, ``alias_bytes``, ``code_bytes``) as
  ``null`` with the reason.

Importing this module touches no process group and no device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Iterator, Optional, Sequence, Tuple

_PRODUCTION = {False: ((16, 16), ("data", "model")),
               True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh as axis sizes and names only; ``shape`` maps name → size, as
    a JAX mesh's does."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"AbstractMesh: {self.axis_sizes} against "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(mesh.axis_names if names is None else names)


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name → size (a ``DeviceMesh``'s ``shape`` is a tuple, an
    :class:`AbstractMesh`'s a dict)."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(axis_names(mesh), mesh.shape))


def axes_size(mesh, axes: Sequence[str]) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialised
    process group, which must have ``prod(shape)`` ranks (torchrun, or
    spawned ranks that call ``torch.distributed.init_process_group``).  Its
    device type follows the group's backend: ``cuda`` for NCCL, ``cpu`` for
    gloo (which also carries CUDA tensors, as ``chip_smoke.py``'s
    ``[sharded-w2]`` and ``[model-sharding]`` run it)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..device import rank_device
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = math.prod(shape)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"make_mesh({shape}) needs a process group of {n} ranks: run "
            "under torchrun (or spawn ranks that call torch.distributed."
            "init_process_group) first")
    if dist.get_world_size() != n:
        raise ValueError(f"make_mesh({shape}) but the process group has "
                         f"{dist.get_world_size()} ranks")
    if dist.get_backend() == "nccl":
        # one card per rank, the sampler mesh's: LOCAL_RANK modulo the cards
        torch.cuda.set_device(rank_device())
        return init_device_mesh("cuda", shape, mesh_dim_names=axes)
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


_AMBIENT = threading.local()


@contextlib.contextmanager
def set_mesh(mesh) -> Iterator[object]:
    """Make ``mesh`` the ambient mesh of this thread inside the block."""
    stack = _AMBIENT.__dict__.setdefault("stack", [])
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


def ambient_mesh():
    """The mesh set by :func:`set_mesh`, or ``None`` when there isn't one."""
    stack = getattr(_AMBIENT, "stack", None)
    return stack[-1] if stack else None


def production_mesh_shape(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh as an :class:`AbstractMesh`."""
    return AbstractMesh(*_PRODUCTION[multi_pod])


def make_production_mesh(*, multi_pod: bool = False):
    return make_mesh(*_PRODUCTION[multi_pod])


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0):
    """Small mesh for the gloo tests (``data · model`` ranks, ``pod`` times
    that with a pod axis)."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"))
    return make_mesh((data, model), ("data", "model"))


def data_axes(mesh) -> tuple:
    """Mesh axes used for DP/FSDP (includes 'pod' when present)."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def model_axes(mesh) -> tuple:
    return ("model",) if "model" in axis_names(mesh) else ()


def axis_group(mesh, axis: str) -> Optional[object]:
    """The process group of this rank along ``axis`` of a ``DeviceMesh``,
    or ``None`` where the axis has size 1 (nothing to exchange)."""
    if isinstance(mesh, AbstractMesh):
        raise TypeError("an AbstractMesh has no process groups")
    return mesh.get_group(axis) if axis_sizes(mesh)[axis] > 1 else None


def axis_index(mesh, axes: Sequence[str]) -> int:
    """This rank's row-major coordinate over ``axes`` (the first axis
    major), ``jax.lax.axis_index`` of those axes."""
    sizes = axis_sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + (mesh.get_local_rank(a) if sizes[a] > 1
                                else 0)
    return idx
