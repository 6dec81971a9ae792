"""Logical-axis sharding rules (MaxText-style) for params, caches and
batches: the counterpart of the reference's ``repro/launch/sharding.py``.

Logical axes emitted by the model code (``param_entries``,
``cache_entries``, ``train_state_logical_axes``):
  "embed"   — d_model rows of weights  -> FSDP over ("pod","data")
  "heads"   — attention head dims      -> TP over "model"
  "mlp"     — FFN hidden               -> TP over "model"
  "vocab"   — embedding rows           -> TP over "model"
  "experts" — MoE expert axis          -> EP over "model"
  "layer"   — stacked layer axis       -> never sharded
  "batch"   — activation batch         -> DP over ("pod","data")
  "kvseq"   — KV-cache sequence        -> SP ("model", or ("data","model")
                                          when the batch axis is unsharded)
  None      — replicated

A rule maps a logical name to mesh axes *if divisibility holds*, otherwise
the dim is replicated (no uneven shards).

:func:`spec_for` gives the port's own :class:`PartitionSpec`: one entry per
tensor dim, each ``None``, a mesh-axis name or a tuple of names, trailing
``None``\\ s dropped, as JAX's ``PartitionSpec`` reads.  Every function
takes a ``DeviceMesh`` or a plain description of one
(:class:`~repro_torch.launch.mesh.AbstractMesh`): the production meshes,
(16, 16) and (2, 16, 16), are computed and tested without 256 ranks.
:class:`NamedSharding` pairs a mesh with a spec; its ``placements`` are the
DTensor placements of that spec (``Shard(dim)`` or ``Replicate()`` per
mesh dim, in the mesh's axis order).

What is left out, and why: the reference's ``shard_activations``,
``shard_logits`` and ``_constrain`` are GSPMD constraints on traced
values; without a mesh they are no-ops, and eager PyTorch has no
counterpart to a constraint.  The reference's train CLI runs no mesh, and
the port adds no sharded train loop: these rules describe the layouts,
:func:`repro_torch.models.moe.moe_ffn_dist` runs the one per-rank path the
reference runs under ``shard_map``, and the dry-run
(:mod:`repro_torch.launch.dryrun`) consumes the rules for each rank's
argument bytes (its traced step is the port's own "dp+ep" program).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

from .mesh import axes_size, axis_names, data_axes, model_axes


class PartitionSpec(tuple):
    """Per tensor dim: ``None`` (replicated), a mesh-axis name, or a tuple
    of names (sharded over their product, the first major)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def rules(mesh, *, batch_sharded: bool = True) -> Dict[str, Tuple[str, ...]]:
    da = data_axes(mesh)
    ma = model_axes(mesh)
    return {
        "embed": da,
        "heads": ma,
        "mlp": ma,
        "vocab": ma,
        "experts": ma,
        "layer": (),
        "batch": da if batch_sharded else (),
        "kvseq": ma if batch_sharded else (da + ma),
    }


def spec_for(mesh, shape: Sequence[int], logical: Sequence[Optional[str]],
             rule: Mapping[str, Tuple[str, ...]]) -> PartitionSpec:
    parts = []
    used: set = set()
    for dim, name in zip(shape, logical):
        axes = rule.get(name, ()) if name else ()
        axes = tuple(a for a in axes if a not in used)
        if axes and dim % axes_size(mesh, axes) == 0:
            parts.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (JAX's ``NamedSharding``)."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim: ``Shard(i)`` where tensor
        dim ``i`` is sharded over that axis, else ``Replicate()``."""
        try:
            from torch.distributed.tensor import Replicate, Shard
        except ImportError:                     # torch < 2.4
            from torch.distributed._tensor import Replicate, Shard
        out = []
        for axis in axis_names(self.mesh):
            dims = [i for i, p in enumerate(self.spec)
                    if p == axis or (isinstance(p, tuple) and axis in p)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)


def tree_shardings(mesh, shapes: Mapping[str, object],
                   logical: Mapping[str, Tuple[Optional[str], ...]],
                   *, batch_sharded: bool = True
                   ) -> Dict[str, NamedSharding]:
    """``shapes``: name -> anything with a ``.shape`` (a meta tensor from
    :func:`repro_torch.train.train_step.train_state_specs`)."""
    r = rules(mesh, batch_sharded=batch_sharded)
    return {k: NamedSharding(mesh, spec_for(mesh, tuple(s.shape), logical[k],
                                            r))
            for k, s in shapes.items()}


def batch_sharding(mesh, global_batch: int) -> NamedSharding:
    da = data_axes(mesh)
    if global_batch % axes_size(mesh, da) == 0:
        return NamedSharding(mesh, PartitionSpec(da if len(da) > 1 else da[0]))
    return NamedSharding(mesh, PartitionSpec())


def batch_is_sharded(mesh, global_batch: int) -> bool:
    return global_batch % axes_size(mesh, data_axes(mesh)) == 0


def frontend_sharding(mesh, global_batch: int) -> NamedSharding:
    da = data_axes(mesh)
    if global_batch % axes_size(mesh, da) == 0:
        return NamedSharding(mesh, PartitionSpec(
            da if len(da) > 1 else da[0], None, "model"))
    return NamedSharding(mesh, PartitionSpec(None, None, "model"))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
