"""The port's dry-run (``repro_torch.launch.dryrun``) and its census of a
traced step (``repro_torch.launch.hlo_census``), on the CPU.

* ``param_counts``, ``model_flops``, ``analytic_memory_bytes`` and
  ``input_specs`` equal the reference's on all 40 cells of
  ``configs.all_cells()`` on both production meshes (the reference module
  sets ``XLA_FLAGS`` when imported; the test puts it back before any jax
  backend starts, and nothing here starts one);
* ``lower_cell`` traces a full-width decode cell (mamba2-780m
  ``decode_32k`` on a fake (4, 4) group, as the reference's
  ``tests/test_dryrun_cells.py:25`` compiles it): ~780 M parameters, a
  rank's arguments under 64 GiB, a dominant roofline term, the ``null``
  fields with their reasons;
* the census's matmul FLOPs of one train step of a one-layer smoke model
  over ``model_flops`` (6·N_active·tokens) is held within 2 % of its
  measured ratio for each arch (:data:`FLOPS_RATIO`): the census also
  counts the loss head's logits (the embedding is not in N_active) with
  their recompute, attention's QKᵀ and PV with the backward's recompute
  of QKᵀ, and the MoE's capacity slots, so every ratio exceeds 1.  A
  matmul counted twice or a backward dropped moves it by more; the
  reference bounds its census by (0.4, 2)·XLA's count
  (``tests/test_dryrun_cells.py:45``);
* a collective's bytes are its input operands (an all-gather's shard, an
  all-reduce's or a reduce-scatter's whole input), alike for the
  in-place ``torch.distributed`` form and the functional one;
* the census scaled from one and two blocks equals the whole trace at
  smoke depth, every record and total, with the L2 limit lowered so that
  the HBM split is not trivially zero (train, prefill and decode; dense,
  gemma2, moe with its collectives, mamba2, zamba2 and encdec);
* B4 is counted by name in a decode census, once per
  ``attention_calls_per_step``.

The fake process group lives in this process only inside
``dryrun.fake_mesh``, which destroys it on exit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import (SHAPES, ShapeCell, all_cells, get_config,
                                 get_smoke_config)
from repro_torch.launch import dryrun, hlo_census
from repro_torch.launch.mesh import production_mesh_shape
from repro_torch.models.serve import attention_calls_per_step


def _reference_dryrun():
    flags = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags
    return ref


class _RefMesh:
    """What the reference's arithmetic reads of a JAX mesh."""

    def __init__(self, m):
        self.devices = np.empty(m.axis_sizes, dtype=np.int8)
        self.shape = dict(zip(m.axis_names, m.axis_sizes))


def test_arithmetic_and_input_specs_equal_reference():
    import jax.numpy as jnp
    from repro.configs import get_config as ref_config
    ref = _reference_dryrun()
    cells = all_cells()
    assert len(cells) == 40
    meshes = [production_mesh_shape(multi_pod=mp) for mp in (False, True)]
    dtypes = {torch.int32: jnp.int32, torch.bfloat16: jnp.bfloat16,
              torch.float32: jnp.float32}
    for arch, shape, _, _ in cells:
        cfg, rcfg = get_config(arch), ref_config(arch)
        assert dryrun.param_counts(cfg) == ref.param_counts(rcfg)
        assert dryrun.model_flops(cfg, shape) == ref.model_flops(rcfg, shape)
        for m in meshes:
            assert dryrun.analytic_memory_bytes(cfg, shape, m) == \
                ref.analytic_memory_bytes(rcfg, shape, _RefMesh(m))
        got, want = dryrun.input_specs(cfg, shape), ref.input_specs(rcfg,
                                                                    shape)
        if "cache" in want:
            got, want = ({**g.pop("cache"), **g} for g in (got, dict(want)))
        assert got.keys() == want.keys()
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), (arch, k)
            assert dtypes[got[k].dtype] == want[k].dtype, (arch, k)
            assert got[k].device.type == "meta"


def test_lower_cell_traces_a_full_width_decode_cell():
    with dryrun.fake_mesh((4, 4), ("data", "model")) as mesh:
        res = dryrun.lower_cell("mamba2-780m", "decode_32k", mesh)
    r = res["roofline"]
    assert res["mesh"] == [4, 4] and res["partitioning"] == "dp+ep"
    assert r["params_total"] > 5e8                   # ~780M
    assert 0 < res["memory"]["argument_bytes"] < 64 * 2**30
    assert r["dominant"] in ("compute", "memory", "collective")
    assert r["compute_s"] > 0 and r["memory_s"] > 0
    assert res["depth"] == {"scaled": True, "block": "layer", "blocks": 48,
                            "traced_blocks": [1, 2]}
    # mamba2 decodes without attention: no B4, and no collective at all
    assert res["kernel_calls"] == {} and res["collectives"] == {"total": 0}
    for k in ("temp_bytes", "alias_bytes", "code_bytes", "per_device_total"):
        assert res["memory"][k] is None and res["memory"]["no_counterpart"][k]
    assert res["cost_raw"] is None and res["cost_raw_reason"]
    assert res["while_trip_counts"] == {}
    # a rank's FLOPs: the whole batch shard through every dense layer
    assert r["hlo_flops_per_chip"] > r["model_flops_per_chip"]


@pytest.fixture
def tiny_cells(monkeypatch):
    """Cells of the smoke models' size (the configs' chunks divide them)."""
    for name, (S, B, kind) in {"tiny_train": (64, 8, "train"),
                               "tiny_prefill": (64, 4, "prefill"),
                               "tiny_decode": (64, 4, "decode")}.items():
        monkeypatch.setitem(SHAPES, name, ShapeCell(name, S, B, kind))


# census FLOPs / model_flops of one train step (B 8 × S 64) of the smoke
# model at one layer (gemma2: one local+global pair), remat off
FLOPS_RATIO = {"minitron-8b": 2.4324, "gemma2-9b": 1.8381,
               "mamba2-780m": 2.7370, "phi3.5-moe-42b-a6.6b": 2.6518,
               "arctic-480b": 3.0374}


@pytest.mark.parametrize("arch", sorted(FLOPS_RATIO))
def test_census_flops_bound_model_flops(tiny_cells, arch):
    cfg = dataclasses.replace(
        get_smoke_config(arch), n_layers=2 if arch == "gemma2-9b" else 1,
        remat=False, q_chunk=64, kv_chunk=64, loss_chunk=64)
    with dryrun.fake_mesh((1, 1), ("data", "model")) as mesh:
        cs, depth, _, _ = dryrun.trace_cell(cfg, arch, "tiny_train", mesh)
    assert depth["scaled"] is False
    _, active = dryrun.param_counts(cfg)
    ratio = cs.flops / (6.0 * active * 64 * 8)
    assert abs(ratio / FLOPS_RATIO[arch] - 1.0) < 0.02, ratio


def test_census_counts_a_collective_by_its_input_operands():
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    shard = torch.empty(8, 16, device="meta")
    full = torch.empty(32, 16, device="meta")
    with dryrun.fake_mesh((1, 4), ("data", "model")) as mesh:
        g = mesh["model"].get_group()
        _, inplace = hlo_census.census(dist.all_gather_into_tensor, full,
                                       shard, group=g)
        _, functional = hlo_census.census(fc.all_gather_tensor, shard, 0, g)
        _, reduce = hlo_census.census(dist.all_reduce, full, group=g)
        _, scatter = hlo_census.census(dist.reduce_scatter_tensor, shard,
                                       full, group=g)
    assert inplace.collective_bytes == functional.collective_bytes == {
        "all-gather": 8 * 16 * 4}
    assert inplace.collective_counts == functional.collective_counts == {
        "all-gather": 1}
    assert reduce.collective_bytes == {"all-reduce": 32 * 16 * 4}
    assert scatter.collective_bytes == {"reduce-scatter": 32 * 16 * 4}
    # the gathered result is written once: shard read + result written
    assert inplace.bytes_accessed == (8 + 32) * 16 * 4


SCALED = [  # arch, depth overrides, cell, mesh
    ("minitron-8b", dict(n_layers=4), "tiny_train", (2, 2)),
    ("phi3.5-moe-42b-a6.6b", dict(n_layers=3), "tiny_prefill", (2, 2)),
    ("gemma2-9b", dict(n_layers=6), "tiny_decode", (2, 2)),
    ("mamba2-780m", dict(n_layers=3), "tiny_train", (1, 2)),
    ("zamba2-7b", dict(n_layers=10), "tiny_prefill", (1, 2)),
    ("whisper-medium", dict(n_layers=3, n_enc_layers=3), "tiny_decode",
     (2, 1)),
    # as many groups as SSM layers in a group, and no tail: the cut is by
    # block, not by the length of a stack
    ("zamba2-7b", dict(n_layers=12, mamba_per_attn=3), "tiny_train", (1, 2)),
]
SCALED_IDS = [c[0] for c in SCALED[:-1]] + ["zamba2-7b-groups-as-long"]


@pytest.mark.parametrize("arch,over,cell,shape", SCALED, ids=SCALED_IDS)
def test_scaled_census_equals_the_whole_trace(tiny_cells, monkeypatch, arch,
                                              over, cell, shape):
    monkeypatch.setattr(hlo_census, "L2_RESIDENT_LIMIT", 4096)
    cfg = dataclasses.replace(get_smoke_config(arch), **over)
    with dryrun.fake_mesh(shape, ("data", "model")) as mesh:
        scaled, how, in1, out1 = dryrun.trace_cell(cfg, arch, cell, mesh)
        whole, _, in2, out2 = dryrun.trace_cell(cfg, arch, cell, mesh,
                                                full_depth=True)
    assert how["scaled"] and how["blocks"] >= 3 and how["traced_blocks"] == [
        1, 2]
    assert scaled.records == whole.records
    for f in ("flops", "bytes_accessed", "hbm_bytes", "collective_bytes",
              "collective_counts"):
        assert getattr(scaled, f) == getattr(whole, f), f
    assert 0 < whole.hbm_bytes < whole.bytes_accessed
    assert (in1, out1) == (in2, out2)
    if arch.startswith("phi3.5"):
        # moe_ffn_dist over "model": one all_reduce a layer
        assert whole.collective_counts == {"all-reduce": 3}
    if SHAPES[cell].kind == "decode":
        calls = sum(n for k, n in whole.records.items()
                    if k[0] == "repro_torch.decode_attention")
        assert calls == attention_calls_per_step(cfg) > 0
