"""Multi-pod dry-run: trace every (arch × shape × mesh) cell's step.

The counterpart of the reference's ``repro/launch/dryrun.py``.  For each
cell it writes ``artifacts/<mesh>/<arch>__<shape>.json`` with:

* ``memory.argument_bytes``: each rank's local shard of the state and the
  batch under :func:`repro_torch.launch.sharding.tree_shardings`' layout
  (the reference's ``argument_size_in_bytes``), in the port's dtypes (bf16
  weights and float32 norms for prefill and decode, where the reference
  lowers float32 parameters); ``traced_argument_bytes`` the inputs of the
  traced program itself;
* ``cost``: FLOPs and bytes of one rank's step from the census of a traced
  step (:mod:`repro_torch.launch.hlo_census`);
* ``collectives``: bytes and counts by kind;
* ``roofline``: the reference's terms and keys (compute / memory /
  collective seconds, the dominant one, ``MODEL_FLOPS`` = 6·N_active·D for
  train and 2·N_active·D for prefill and decode), from the H100 figures
  below; ``hlo_flops_per_chip`` holds the traced step's FLOPs.

**What the numbers describe.** The step is traced once on tensors of the
meta device (shapes and dtypes, no data: nothing is allocated, nothing
launched) over a fake process group of the mesh's size (``FakeStore``,
backend ``"fake"``) on rank 0.  Meta tensors rather than
``FakeTensorMode``'s fake CUDA tensors: the same operators and shapes at
about a third of the time an operator (PERF.md §6), and a CPU-only
PyTorch cannot index a fake CUDA tensor from Python.  B4 is
reached through its operator's Meta implementation all the same
(:mod:`repro_torch.kernels.attention`).  It is one rank of *the port's* program, whose partitioning is
``"dp+ep"``: the batch is split over the data axes, every dense layer runs
replicated over "model", and only the experts are split over "model"
(:func:`repro_torch.models.moe.moe_ffn_dist` on the "model" sub-mesh, one
``all_reduce`` a MoE layer).  The port has no tensor parallelism (the
GSPMD partitioning the reference's compiler derives has no eager
counterpart), so a rank's FLOPs exceed ``model_flops / n_chips`` by about
the size of the "model" axis, and the train step carries no gradient
reduction over the data axes (the port, like the reference's train CLI,
runs no sharded train loop).  Decode's MoE FFN is ``moe_ffn`` with every
expert on every rank, as ``decode_step`` calls it.

**Depth.** By default the step is traced at one and two blocks (a layer; a
gemma2 local+global pair; a zamba2 group; a whisper encoder+decoder layer
pair) and the census is extended to the full depth
(:func:`repro_torch.launch.hlo_census.scale_census`), the counterpart of
the reference's while-trip scaling: at S 32768 the attention's tile loops
issue ~4k live tiles a layer, too many to trace every layer of every cell.
The scaled census equals the whole trace record for record
(``tests/test_torch_dryrun.py``).

**No counterpart**, reported as ``null`` with the reason beside it: XLA's
``temp_bytes``, ``alias_bytes`` and ``code_bytes`` (eager PyTorch has no
compiled buffer plan and no generated code), ``per_device_total`` (it
needs ``temp_bytes``), ``cost_raw`` (XLA's own cost analysis), the
reference's ``parse_collective_bytes`` (HLO text) and ``while_trip_counts``
(``{}``: the port's layer loops are Python).  ``compile_s`` goes: nothing
is compiled; ``lower_s`` becomes ``trace_s``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--mesh single|multi|both] [--out artifacts/]
        [--lower-only]

It runs on the CPU with no card and exits 1 if a cell fails.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch

from ..configs import ASSIGNED_ARCHS, SHAPES, cell_runnable, get_config
from ..models import serve as mserve
from ..models.transformer import (ModelConfig, logical_axes, param_dtype,
                                  param_entries)
from ..train.optimizer import default_opt_for
from ..train.train_step import (TrainConfig, make_train_step,
                                train_state_logical_axes, train_state_specs)
from .hlo_census import (CensusResult, census, scale_census,
                          top_contributors)
from .mesh import (AbstractMesh, axis_names, axis_sizes, data_axes,
                   production_mesh_shape, set_mesh)
from .sharding import (NamedSharding, batch_is_sharded, batch_sharding,
                       frontend_sharding, replicated, tree_shardings)

# -- hardware constants (H100 SXM datasheet) ---------------------------------
PEAK_FLOPS = 989e12     # bf16 dense FLOP/s, NVIDIA H100 80GB HBM3, 700 W
HBM_BW = 3.35e12        # HBM3 bytes/s, NVIDIA H100 80GB HBM3, 700 W
NVLINK_BW = 900e9       # NVLink bytes/s per card, NVIDIA H100 80GB HBM3, 700 W

PARTITIONING = "dp+ep"
N_MICRO_ARCHS = ("mistral-large-123b", "arctic-480b", "phi3.5-moe-42b-a6.6b",
                 "zamba2-7b")
NO_COUNTERPART = {
    "temp_bytes": "eager PyTorch has no compiled buffer plan",
    "alias_bytes": "no donation: a train step updates its state in place",
    "code_bytes": "no generated code: eager operators and prebuilt kernels",
    "per_device_total": "needs XLA's temp_bytes",
    "cost_raw": "XLA's cost analysis of a compiled program",
}


# ---------------------------------------------------------------------------
# Model FLOPs accounting (6·N_active·D)
# ---------------------------------------------------------------------------


def param_counts(cfg: ModelConfig) -> Tuple[float, float]:
    """(total, active) parameter counts (active discounts un-routed experts)."""
    shapes = {k: shp for k, (shp, _) in param_entries(cfg).items()}
    total = float(sum(math.prod(s) for s in shapes.values()))
    embed = float(math.prod(shapes["embed"]))
    expert = float(sum(math.prod(s) for k, s in shapes.items()
                       if "moe_w_" in k))
    active = total - embed
    if cfg.n_experts:
        active -= expert * (1.0 - cfg.top_k / cfg.n_experts)
    return total, active


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    cell = SHAPES[shape_name]
    total, active = param_counts(cfg)
    if cell.kind == "train":
        return 6.0 * active * cell.seq_len * cell.global_batch
    if cell.kind == "prefill":
        return 2.0 * active * cell.seq_len * cell.global_batch
    # decode: one token per sequence
    return 2.0 * active * cell.global_batch


# ---------------------------------------------------------------------------
# Analytic per-device HBM traffic model (the roofline memory term): the
# reference's structural model of what must cross HBM under its layout —
# weights (gathered, per pass), saved residuals, attention K/V chunk
# re-reads, loss-head embedding/logits chunks, KV-cache reads, optimizer
# state.  Formulas per cell kind, as the reference writes them.
# ---------------------------------------------------------------------------


def analytic_memory_bytes(cfg: ModelConfig, shape_name: str, mesh) -> float:
    cell = SHAPES[shape_name]
    sizes = axis_sizes(mesh)
    n_chips = math.prod(sizes.values())
    tp = sizes.get("model", 1)
    dp = n_chips // tp
    B_loc = max(cell.global_batch // dp, 1)
    S = cell.seq_len
    total, active = param_counts(cfg)
    p_expert = sum(float(math.prod(shp))
                   for k, (shp, _) in param_entries(cfg).items()
                   if "moe_w_" in k)
    p_dense = total - p_expert
    # per-device weight bytes read per pass (bf16): FSDP gathers the dense
    # weights to every device; experts stay EP-local
    w_pass = (p_dense + p_expert / tp) * 2.0

    if cell.kind == "train":
        passes = 3.0      # fwd + bwd (2x weight reads: dgrad + wgrad)
        opt = (total / n_chips) * (4 + 4 + 8)   # master r/w + moment traffic
        resid = cfg.n_layers * B_loc * (S / tp) * cfg.d_model * 2 * 2
        attn_kv = 0.0
        if cfg.n_heads:
            nq = max(S // cfg.q_chunk, 1)
            h_loc = max(cfg.n_heads / tp, 1)
            attn_kv = (cfg.n_layers * B_loc * S * h_loc * cfg.head_dim
                       * 2 * 2 * nq * 3)
        nc = max(S // cfg.loss_chunk, 1)
        loss = nc * (cfg.vocab / tp) * cfg.d_model * 2 * 2   # embed reads f+b
        loss += B_loc * S * (cfg.vocab / tp) * 4 * 2          # logits w+r
        return w_pass * passes + opt + resid + attn_kv + loss
    if cell.kind == "prefill":
        resid = cfg.n_layers * B_loc * (S / tp) * cfg.d_model * 2
        attn_kv = 0.0
        if cfg.n_heads:
            nq = max(S // cfg.q_chunk, 1)
            h_loc = max(cfg.n_heads / tp, 1)
            attn_kv = cfg.n_layers * B_loc * S * h_loc * cfg.head_dim * 2 * 2 * nq
        return w_pass + resid + attn_kv
    # decode: weights shard read once + full cache read/write
    cache = mserve.cache_entries(cfg, cell.global_batch, S)
    cache_bytes = sum(float(math.prod(shp)) * 2 for shp, _ in cache.values())
    return total * 2 / n_chips + cache_bytes / n_chips * 1.01


# ---------------------------------------------------------------------------
# input specs per (arch, shape)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape_name: str, *,
                batch: Optional[int] = None) -> Dict[str, Any]:
    """Shape-and-dtype stand-ins (tensors on the meta device) for every
    model input of the cell; ``batch`` replaces the cell's global batch (a
    rank's shard)."""
    cell = SHAPES[shape_name]
    B, S = (cell.global_batch if batch is None else batch), cell.seq_len
    i32, dt = torch.int32, cfg.compute_dtype

    def spec(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cell.kind in ("train", "prefill"):
        toks = S
        out = {}
        if cfg.frontend in ("patch", "audio"):
            if cfg.frontend == "patch":
                toks = S - cfg.n_frontend_tokens
            out["frontend"] = spec((B, cfg.n_frontend_tokens, cfg.d_model), dt)
        out["tokens"] = spec((B, toks), i32)
        if cell.kind == "train":
            out["targets"] = spec((B, toks), i32)
        return out
    # decode
    return {
        "cache": {k: spec(shp, dt) for k, (shp, _) in
                  mserve.cache_entries(cfg, B, S).items()},
        "tokens": spec((B, 1), i32),
        "lengths": spec((B,), i32),
    }


# ---------------------------------------------------------------------------
# the fake mesh and the traced step
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_mesh(shape: Sequence[int], axes: Sequence[str]) -> Iterator[object]:
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over a fake process
    group of ``prod(shape)`` ranks, this process rank 0; the group is
    destroyed on exit.  Collectives on it move nothing and return at once;
    ``CommDebugMode`` counts them."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_mesh: a process group is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", tuple(shape),
                               mesh_dim_names=tuple(axes))
    finally:
        dist.destroy_process_group()


def _local_bytes(t, sharding: NamedSharding) -> int:
    """Bytes of one rank's shard of ``t`` under ``sharding``."""
    sizes = axis_sizes(sharding.mesh)
    n = 1
    for i, d in enumerate(t.shape):
        part = sharding.spec[i] if i < len(sharding.spec) else None
        axes = () if part is None else (part if isinstance(part, tuple)
                                         else (part,))
        n *= d // math.prod(sizes[a] for a in axes)
    return n * t.element_size()


def _nbytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _param_specs(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The served parameters as the port holds them (``param_dtype``), on
    the meta device."""
    return {k: torch.empty(shp, dtype=param_dtype(cfg, k, shp), device="meta")
            for k, (shp, _) in param_entries(cfg).items()}


def _train_config(arch: str) -> TrainConfig:
    return TrainConfig(opt=default_opt_for(arch),
                       n_microbatches=4 if arch in N_MICRO_ARCHS else 1)


def argument_bytes(arch: str, shape_name: str, mesh) -> int:
    """Each rank's shard of the cell's state and batch under
    ``tree_shardings`` (the reference's ``argument_size_in_bytes``)."""
    cfg, cell = get_config(arch), SHAPES[shape_name]
    B = cell.global_batch
    batch = input_specs(cfg, shape_name)
    if cell.kind == "decode":
        cache = batch["cache"]
        csh = tree_shardings(mesh, cache,
                             mserve.cache_logical_axes(cfg, B, cell.seq_len),
                             batch_sharded=batch_is_sharded(mesh, B))
        tsh = batch_sharding(mesh, B)
        out = sum(_local_bytes(cache[k], csh[k]) for k in cache)
        out += sum(_local_bytes(batch[k], tsh) for k in ("tokens", "lengths"))
    else:
        out = sum(_local_bytes(v, frontend_sharding(mesh, B) if k == "frontend"
                               else batch_sharding(mesh, B))
                  for k, v in batch.items())
    if cell.kind == "train":
        tc = _train_config(arch)
        specs, lax_ = train_state_specs(cfg, tc), train_state_logical_axes(
            cfg, tc)
        out += _local_bytes(specs["step"], replicated(mesh))
        for part in ("params", "opt"):
            sh = tree_shardings(mesh, specs[part], lax_[part])
            out += sum(_local_bytes(v, sh[k]) for k, v in specs[part].items())
    else:
        params = _param_specs(cfg)
        sh = tree_shardings(mesh, params, logical_axes(cfg))
        out += sum(_local_bytes(v, sh[k]) for k, v in params.items())
    return out


@dataclasses.dataclass(frozen=True)
class Depth:
    """How a model's depth is counted in blocks: what a block is and the
    full count (the steps' ``_blocks`` keyword runs the first few)."""

    block: str
    blocks: int


def depth_units(cfg: ModelConfig) -> Optional[Depth]:
    """The model's blocks, or ``None`` where they are not alike (an encoder
    and a decoder of different depths)."""
    if cfg.family == "gemma2" and cfg.n_layers % 2 == 0:
        return Depth("local+global layer pair", cfg.n_layers // 2)
    if cfg.family == "zamba2":
        return Depth(f"group of {cfg.mamba_per_attn} SSM layers + the "
                     "shared block", cfg.n_zamba_groups)
    if cfg.family == "encdec":
        if cfg.n_enc_layers != cfg.n_layers:
            return None
        return Depth("encoder layer + decoder layer", cfg.n_layers)
    return Depth("layer", cfg.n_layers)


def _trace(cfg: ModelConfig, arch: str, shape_name: str, mesh, u: int = 0
           ) -> Tuple[CensusResult, int, int]:
    """One rank's step of the cell on meta tensors under the census, over
    the full model's inputs, running its first ``u`` blocks (every layer
    with ``u`` 0): (census, input bytes, output bytes).  The stacked
    tensors stay whole, so the backward and the optimizer see the
    full-depth shapes."""
    cell = SHAPES[shape_name]
    sizes = axis_sizes(mesh)
    dp = math.prod(sizes[a] for a in data_axes(mesh))
    B = cell.global_batch
    B_loc = B // dp if batch_is_sharded(mesh, B) else B
    ep = (mesh["model"] if "model" in axis_names(mesh)
          and sizes["model"] > 1 else None)
    batch = input_specs(cfg, shape_name, batch=B_loc)
    blocks = u or None
    if cell.kind == "train":
        tc = _train_config(arch)
        state = train_state_specs(cfg, tc)
        args = (state, batch)
        fn = make_train_step(cfg, tc, _blocks=blocks)
    elif cell.kind == "prefill":
        args = (_param_specs(cfg), batch)
        fn = lambda p, b: mserve.prefill_step(  # noqa: E731
            p, cfg, b, _blocks=blocks)
    else:
        args = (_param_specs(cfg), batch["cache"], batch["tokens"],
                batch["lengths"])
        fn = lambda p, c, t, n: mserve.decode_step(  # noqa: E731
            p, cfg, c, t, n, _blocks=blocks)
    with contextlib.ExitStack() as stack:
        if ep is not None:
            stack.enter_context(set_mesh(ep))
        if cell.kind != "train":
            stack.enter_context(torch.no_grad())
        out, cs = census(fn, *args)
    return cs, _nbytes(args), _nbytes(out)


def trace_cell(cfg: ModelConfig, arch: str, shape_name: str, mesh, *,
               full_depth: bool = False
               ) -> Tuple[CensusResult, Dict[str, Any], int, int]:
    """The census of one rank's step: traced at one and two blocks and
    scaled to the full depth, or traced whole (``full_depth``, or where the
    blocks are not alike, or two or fewer).  Returns (census, how the depth
    was reached, input bytes, output bytes)."""
    depth = None if full_depth else depth_units(cfg)
    if depth is None or depth.blocks <= 2:
        cs, in_b, out_b = _trace(cfg, arch, shape_name, mesh)
        return cs, {"scaled": False, "blocks": None if depth is None
                    else depth.blocks}, in_b, out_b
    one, in_b, out_b = _trace(cfg, arch, shape_name, mesh, 1)
    two, _, _ = _trace(cfg, arch, shape_name, mesh, 2)
    return scale_census(one, two, depth.blocks), {
        "scaled": True, "block": depth.block, "blocks": depth.blocks,
        "traced_blocks": [1, 2]}, in_b, out_b


# ---------------------------------------------------------------------------
# cell lowering
# ---------------------------------------------------------------------------


def lower_cell(arch: str, shape_name: str, mesh, *, trace: bool = True
               ) -> Dict[str, Any]:
    """One cell on ``mesh``: a ``DeviceMesh`` over a fake group
    (:func:`fake_mesh`) or an :class:`AbstractMesh`, for which one is made.
    ``trace=False`` reports the arithmetic and the layout only (the
    reference's ``compile_=False``)."""
    if isinstance(mesh, AbstractMesh) and trace:
        with fake_mesh(mesh.axis_sizes, mesh.axis_names) as m:
            return lower_cell(arch, shape_name, m)
    cfg = get_config(arch)
    cell = SHAPES[shape_name]
    sizes = axis_sizes(mesh)
    n_chips = math.prod(sizes.values())
    t0 = time.perf_counter()
    res: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": [sizes[a] for a in axis_names(mesh)],
        "mesh_axes": list(axis_names(mesh)),
        "partitioning": PARTITIONING,
        "partitioning_note": (
            "one rank of the port's program: batch split over the data "
            "axes, dense layers replicated over 'model', experts split over "
            "'model' (moe_ffn_dist); no tensor parallelism and no gradient "
            "reduction over the data axes"),
    }
    arg_b = argument_bytes(arch, shape_name, mesh)
    total, active = param_counts(cfg)
    mf = model_flops(cfg, shape_name)
    analytic_bytes = analytic_memory_bytes(cfg, shape_name, mesh)
    if not trace:
        res["memory"] = {"argument_bytes": arg_b}
        res["roofline"] = {"n_chips": n_chips, "model_flops_total": mf,
                           "model_flops_per_chip": mf / n_chips,
                           "analytic_bytes": analytic_bytes,
                           "params_total": total, "params_active": active}
        res["trace_s"] = time.perf_counter() - t0
        return res
    cs, depth, in_b, out_b = trace_cell(cfg, arch, shape_name, mesh)
    res["trace_s"] = time.perf_counter() - t0
    res["depth"] = depth
    res["memory"] = {
        "argument_bytes": arg_b,
        "traced_argument_bytes": in_b,
        "output_bytes": out_b,
        **{k: None for k in ("temp_bytes", "alias_bytes", "code_bytes",
                             "per_device_total")},
        "no_counterpart": {k: NO_COUNTERPART[k] for k in (
            "temp_bytes", "alias_bytes", "code_bytes", "per_device_total")},
    }
    res["cost_raw"] = None
    res["cost_raw_reason"] = NO_COUNTERPART["cost_raw"]
    flops = cs.flops
    res["cost"] = {"flops": flops, "bytes_accessed": cs.hbm_bytes,
                   "bytes_upper_bound": cs.bytes_accessed}
    res["collectives"] = {**cs.collective_bytes,
                          **{"count_" + k: v
                             for k, v in cs.collective_counts.items()},
                          "total": cs.total_collective_bytes}
    res["while_trip_counts"] = cs.while_trip_counts
    # the port's own kernels by name (B4: repro_torch.decode_attention),
    # and the heaviest aten operators
    res["kernel_calls"] = {}
    for (op, *_), n in cs.records.items():
        if op.startswith("repro_torch."):
            res["kernel_calls"][op] = res["kernel_calls"].get(op, 0) + n
    by_bytes, by_flops = top_contributors(cs, 5)
    res["top_ops"] = {"by_bytes": [[op, n, v] for v, n, op in by_bytes],
                      "by_flops": [[op, n, v] for v, n, op in by_flops]}
    compute_t = flops / PEAK_FLOPS
    memory_t = analytic_bytes / HBM_BW
    coll_t = cs.total_collective_bytes / NVLINK_BW
    dominant = max((("compute", compute_t), ("memory", memory_t),
                    ("collective", coll_t)), key=lambda kv: kv[1])[0]
    res["roofline"] = {
        "n_chips": n_chips,
        "compute_s": compute_t,
        "memory_s": memory_t,
        "memory_census_floor_s": cs.hbm_bytes / HBM_BW,
        "memory_upper_s": cs.bytes_accessed / HBM_BW,
        "analytic_bytes": analytic_bytes,
        "collective_s": coll_t,
        "dominant": dominant,
        "model_flops_total": mf,
        "model_flops_per_chip": mf / n_chips,
        "hlo_flops_per_chip": flops,
        "useful_flops_ratio": (mf / n_chips) / flops if flops else 0.0,
        "params_total": total,
        "params_active": active,
    }
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts")
    ap.add_argument("--lower-only", action="store_true",
                    help="the arithmetic and the layout, no trace")
    args = ap.parse_args(argv)

    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single_pod", production_mesh_shape(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi_pod", production_mesh_shape(multi_pod=True)))

    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)

    t_all = time.perf_counter()
    n_ok = n_skip = n_fail = 0
    for mesh_name, mesh in meshes:
        outdir = os.path.join(args.out, mesh_name)
        os.makedirs(outdir, exist_ok=True)
        cm = (contextlib.nullcontext(mesh) if args.lower_only
              else fake_mesh(mesh.axis_sizes, mesh.axis_names))
        with cm as m:
            for arch in archs:
                for shape in shapes:
                    ok, why = cell_runnable(arch, shape)
                    tag = f"{mesh_name}/{arch}__{shape}"
                    path = os.path.join(outdir, f"{arch}__{shape}.json")
                    if not ok:
                        with open(path, "w") as f:
                            json.dump({"arch": arch, "shape": shape,
                                       "skipped": why}, f, indent=1)
                        print(f"SKIP {tag}: {why}", flush=True)
                        n_skip += 1
                        continue
                    try:
                        res = lower_cell(arch, shape, m,
                                         trace=not args.lower_only)
                        with open(path, "w") as f:
                            json.dump(res, f, indent=1)
                        r = res.get("roofline", {})
                        print(f"OK   {tag}: trace={res['trace_s']:.1f}s "
                              f"args/rank="
                              f"{res['memory']['argument_bytes'] / 2**30:.2f}"
                              f"GiB dom={r.get('dominant', '?')}", flush=True)
                        n_ok += 1
                    except Exception as e:
                        n_fail += 1
                        with open(path, "w") as f:
                            json.dump({"arch": arch, "shape": shape,
                                       "error": repr(e),
                                       "traceback": traceback.format_exc()},
                                      f, indent=1)
                        print(f"FAIL {tag}: {e}", flush=True)
    print(f"dry-run done: ok={n_ok} skip={n_skip} fail={n_fail} in "
          f"{time.perf_counter() - t_all:.1f}s", flush=True)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
