"""The port stands alone: no module of ``src/repro_torch`` imports ``jax``
or anything of ``repro``, and its entry points need the card unless the
caller asks for the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "repro"
             or m.startswith("repro."))
new = {"repro_torch.core.distributed", "repro_torch.core.torch_sampler",
       "repro_torch.core.sharding", "repro_torch.core.sharding.catalog",
       "repro_torch.core.sharding.sampler", "repro_torch.core.sharding.stats",
       "repro_torch.configs", "repro_torch.configs.gemma2_9b",
       "repro_torch.configs.zamba2_7b", "repro_torch.models",
       "repro_torch.models.layers", "repro_torch.models.moe",
       "repro_torch.models.serve", "repro_torch.models.ssm",
       "repro_torch.models.transformer", "repro_torch.launch.serve",
       "repro_torch.train", "repro_torch.train.optimizer",
       "repro_torch.train.grad_compress", "repro_torch.train.train_step",
       "repro_torch.data.encode", "repro_torch.data.pipeline",
       "repro_torch.checkpoint", "repro_torch.checkpoint.checkpointer",
       "repro_torch.launch.ft", "repro_torch.launch.train",
       "repro_torch.launch.mesh", "repro_torch.launch.sharding",
       "repro_torch.launch.dryrun", "repro_torch.launch.hlo_census",
       "repro_torch.analysis", "repro_torch.analysis.findings",
       "repro_torch.analysis.lint", "repro_torch.analysis.recompile",
       "repro_torch.analysis.trace_audit", "repro_torch.analysis.rules",
       "repro_torch.analysis.rules.capture_sync",
       "repro_torch.analysis.rules.estimator_pull",
       "repro_torch.analysis.rules.fallbacks",
       "repro_torch.analysis.rules.fixed_point",
       "repro_torch.analysis.rules.int32_packing",
       "repro_torch.analysis.rules.locks",
       "repro_torch.analysis.rules.nondeterminism",
       "repro_torch.analysis.rules.stats_width"}
print(len(names), "modules;", "leaked:", bad, "missing:", new - set(names))
sys.exit(1 if bad or len(names) < 20 or new - set(names) else 0)
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("entry", ["set_union_sampler", "backend", "device",
                                   "ops", "online", "estimator",
                                   "rw_warmup", "disjoint", "bernoulli",
                                   "chain", "distributed", "mesh",
                                   "lm_cli", "serve_lm", "train_cli"])
def test_entry_points_raise_without_a_card(monkeypatch, entry):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.backends.torch_backend import TorchBackend
    from repro_torch.core.distributed import DistributedUnionSampler
    from repro_torch.core.estimators import TorchEstimator
    from repro_torch.core.framework import estimate_union, warmup
    from repro_torch.core.online import OnlineUnionSampler
    from repro_torch.core.sharding import ShardedCatalog, make_sampler_mesh
    from repro_torch.core.torch_sampler import TorchChainSampler
    from repro_torch.core.union_sampler import (BernoulliUnionSampler,
                                                DisjointUnionSampler,
                                                SetUnionSampler)
    from repro_torch.data.workloads import uq1
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models.serve import init_cache
    from repro_torch.models.transformer import init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lm_cfg = get_smoke_config("gemma2-9b")
    wl = uq1(scale=0.05, overlap=0.4, seed=0)
    sizes = {j.name: 1.0 for j in wl.joins}
    keys = np.arange(10)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "set_union_sampler":
            est = estimate_union(warmup(wl.cat, wl.joins,
                                        method="histogram").oracle)
            SetUnionSampler(wl.cat, wl.joins, est.cover, backend="torch")
        elif entry == "backend":
            TorchBackend(wl.cat, wl.joins)
        elif entry == "ops":
            ops.segdegree(keys)
        elif entry == "online":
            OnlineUnionSampler(wl.cat, wl.joins)
        elif entry == "estimator":
            TorchEstimator(wl.cat, wl.joins)
        elif entry == "rw_warmup":
            warmup(wl.cat, wl.joins, method="random_walk")
        elif entry == "disjoint":
            DisjointUnionSampler(wl.cat, wl.joins, sizes)
        elif entry == "bernoulli":
            BernoulliUnionSampler(wl.cat, wl.joins, sizes, 1.0)
        elif entry == "chain":
            TorchChainSampler(wl.cat, wl.joins[0])
        elif entry == "distributed":
            est = estimate_union(warmup(wl.cat, wl.joins,
                                        method="histogram").oracle)
            DistributedUnionSampler(wl.cat, wl.joins, est.cover, rank=0,
                                    world=2)
        elif entry == "mesh":
            ShardedCatalog(wl.cat, wl.joins)
        elif entry == "lm_cli":
            serve_cli.main(["--smoke", "--arch", "gemma2-9b"])
        elif entry == "serve_lm":
            serve_cli.serve_lm(lm_cfg, {}, requests=1)
        elif entry == "train_cli":
            train_cli.main(["--smoke", "--steps", "1"])
        else:
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    if entry in ("lm_cli", "serve_lm"):
        # the LM side's other entry points need the card too, and run
        # with device="cpu"
        for fn in (lambda d: init_params(lm_cfg, 0, device=d),
                   lambda d: init_cache(lm_cfg, 1, 8, device=d)):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(None)
            fn("cpu")
        out = serve_cli.main(["--smoke", "--arch", "gemma2-9b", "--device",
                              "cpu", "--requests", "1", "--max-new", "2"])
        assert len(out["done"]) == 1
    if entry == "train_cli":
        # the training side's other entry points need the card too
        from repro_torch.train.train_step import TrainConfig, init_train_state
        for fn in (lambda d: init_train_state(lm_cfg, TrainConfig(), 0, d),
                   lambda d: train_cli.build_pipeline(
                       "UQ3", 0.01, 0, 1, 16, 512, "histogram", False, d)):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(None)
            fn("cpu")
    if entry == "mesh":
        with pytest.raises(RuntimeError, match="CUDA"):
            make_sampler_mesh()
        assert make_sampler_mesh(device="cpu").device.type == "cpu"
    if entry == "ops":
        for fn in (lambda d: ops.searchsorted(keys, keys, device=d),
                   lambda d: ops.walk_hop(keys, keys, np.zeros(10), device=d),
                   lambda d: ops.ranged_weighted_pick(
                       np.arange(11.0), keys[:3], keys[:3] + 1, np.zeros(3),
                       device=d),
                   lambda d: ops.decode_attention(
                       np.zeros((1, 2, 64), np.float32),
                       np.zeros((1, 4, 1, 64), np.float32),
                       np.zeros((1, 4, 1, 64), np.float32), [4], device=d)):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(None)
            fn("cpu")
        assert ops.segdegree(keys, device="cpu") == (10, 1)
