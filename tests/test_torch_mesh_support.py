"""Multi-process helpers of ``tests/test_torch_sharding.py`` (no tests here).

:func:`spawn` starts ``world`` CPU processes that join one ``gloo`` group
(a free localhost port found by binding to port 0, an init ``timeout``)
and run a worker of this module on each rank; it fails if a rank raises
and kills the ranks if they have not all finished within ``timeout``
seconds.  This module imports neither ``jax`` nor ``repro``, so the spawned
ranks start on ``torch`` and ``repro_torch`` alone.

The workers check on every rank:

* :func:`check_exchange` — the sharded round's fingerprint exchange gives,
  for every (join, earlier piece) of UQ1's five joins, the verdicts of the
  unsharded ``TorchJoinMembership.contains`` on this rank's own candidates;
* :func:`check_moment_merge` — ``psum_merge_moments`` over the ranks equals
  ``merge_statistics`` of per-rank ``RunningMean``s and
  ``merge_moment_stack`` of the gathered moments;
* :func:`check_uniform` — ``SetUnionSampler(mesh=)`` on UQ1 (scale 0.05,
  overlap 0.5, seed 1, two joins; static plan in both loops, adaptive plan)
  and UQ4 (scale 0.02) passes the
  reference's bar: ``N = 120·U`` rows uniform over the exact union
  (chi-square p > 1e-3), every row in its home piece and no earlier one,
  the same ``SampleSet`` on every rank, and UQ1's piece marginals within
  0.03 of the host engine's (``backend="numpy"``);
* :func:`check_device_loop` — the per-rank device loop: the same
  ``SampleSet``, counters and chunks on every rank, one host sync per chunk
  plus the fetch, rows in their home piece, banks drained;
* :func:`check_online` — ``OnlineUnionSampler(mesh=)`` smoke: every size
  accumulator's count is a multiple of ``world · rw_batch``;
* :func:`trace_audit_ranks` (world 2; ``tests/test_torch_analysis.py``)
  — the trace audit's collectives per round of both sharded loops;
* :func:`model_sharding` (world 8; ``tests/test_torch_model_sharding.py``)
  — ``tree_shardings``' placements on a (2, 4) ``DeviceMesh``, and
  ``moe_ffn_dist`` on (2, 4) and (2, 2, 2) meshes, and ``forward_train``
  of arctic's smoke config under the (2, 4) mesh (its MoE layers through
  ``moe_ffn_dist``): the same outputs and the same gradients on every
  rank, which rank 0 writes;
* :func:`compressed_psum_ranks` (world 4) — ``compressed_psum`` over a
  one-axis mesh's group: the same sum on every rank, which rank 0 writes.
"""

import datetime
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, worker, args):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        globals()[worker](world, *args)
    finally:
        dist.destroy_process_group()


def spawn(worker: str, world: int, timeout: float = 120.0, *args) -> None:
    """Run ``worker(world, *args)`` of this module on ``world`` gloo
    ranks."""
    ctx = mp.start_processes(_rank_main,
                             args=(world, free_port(), worker, args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{worker} at world {world} did not finish "
                                   f"within {timeout:.0f} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    assert not any(p.is_alive() for p in ctx.processes)


# ---------------------------------------------------------------------------
# workers (run on every rank)
# ---------------------------------------------------------------------------


def _exact_cover(wl):
    from repro_torch.core.framework import estimate_union, warmup
    return estimate_union(warmup(wl.cat, wl.joins, method="exact").oracle)


def _same_on_every_rank(arr: np.ndarray, world: int) -> None:
    t = torch.as_tensor(np.ascontiguousarray(arr).view(np.int64).reshape(-1))
    g = torch.empty(world * t.numel(), dtype=t.dtype)
    dist.all_gather_into_tensor(g, t)
    g = g.view(world, -1)
    assert all(torch.equal(g[0], g[s]) for s in range(world))


def check_exchange(world: int) -> None:
    from repro_torch.core.backends.torch_backend import (PhiloxUniforms,
                                                         TorchJoinMembership)
    from repro_torch.core.sharding import ShardedUnionSampler, \
        ShardedCatalog, make_sampler_mesh
    from repro_torch.data.workloads import uq1
    wl = uq1(scale=0.05, overlap=0.5, seed=1)
    est = _exact_cover(wl)
    mesh = make_sampler_mesh(world=world, device="cpu")
    assert (mesh.world, mesh.rank) == (world, dist.get_rank())
    eng = ShardedUnionSampler(ShardedCatalog(wl.cat, wl.joins, mesh=mesh),
                              est.cover, seed=0, round_batch=512)
    # every rank indexes only the fingerprints it owns; together they are
    # the whole relation, and kmax is the global one
    rel0 = eng.smems[0].rels[0]
    n = torch.tensor([rel0.n_owned])
    dist.all_reduce(n)
    assert int(n) == rel0.nrows
    u = PhiloxUniforms(100 + mesh.rank, "cpu")
    rows_j = [t.draw(u.tree(t.n_streams, b))[0]
              for t, b in zip(eng.trees, eng.shard_piece_batches)]
    found = eng._exchange_probes(rows_j)
    members = {j.name: TorchJoinMembership(j, device="cpu")
               for j in wl.joins}
    p = hits = total = 0
    for j in range(len(eng.order)):
        for q in range(j):
            got = torch.ones(eng.shard_piece_batches[j], dtype=torch.bool)
            for _ in eng.smems[q].rels:
                got = got & found[p]
                p += 1
            want = members[eng.order[q]].contains(rows_j[j])
            assert torch.equal(got, want), (j, q)
            hits += int(want.sum())
            total += want.numel()
    assert p == len(found) and 0 < hits < total


def check_moment_merge(world: int) -> None:
    from repro_torch.core.distributed import merge_statistics
    from repro_torch.core.sharding import (make_sampler_mesh,
                                           merge_moment_stack,
                                           psum_merge_moments)
    from repro_torch.core.size_estimation import RunningMean
    mesh = make_sampler_mesh(world=world, device="cpu")
    xs = np.random.default_rng(0).exponential(5.0, (world, 64))
    x = torch.as_tensor(xs[mesh.rank], dtype=torch.float32)
    mean = torch.mean(x)
    m2 = torch.sum((x - mean) ** 2)
    n = torch.tensor(x.shape[0], dtype=torch.int32)
    total, gmean, gm2 = psum_merge_moments(n, mean, m2, mesh)
    parts = []
    for s in range(world):
        r = RunningMean()
        r.update_batch(xs[s])
        parts.append(r)
    host = merge_statistics(parts)
    assert int(total) == host.count == world * 64
    np.testing.assert_allclose(float(gmean), host.mean, rtol=1e-5)
    np.testing.assert_allclose(float(gm2), host.m2, rtol=1e-4)
    stack = torch.empty(3 * world, dtype=torch.float32)
    dist.all_gather_into_tensor(stack, torch.stack([n.float(), mean, m2]))
    sn, smean, sm2 = stack.view(world, 3).T
    ref = merge_moment_stack(sn.to(torch.int32), smean, sm2)
    assert int(ref[0]) == int(total)
    np.testing.assert_allclose(float(ref[1]), float(gmean), rtol=1e-6)
    np.testing.assert_allclose(float(ref[2]), float(gm2), rtol=1e-6)


def _chi2_p(mat, U):
    from scipy import stats as sps
    uni, counts = np.unique(mat.view([("", mat.dtype)] * mat.shape[1]).ravel(),
                            return_counts=True)
    exp = mat.shape[0] / U
    chi2 = float(((counts - exp) ** 2 / exp).sum()) + (U - uni.shape[0]) * exp
    return 1 - sps.chi2.cdf(chi2, df=U - 1)


def check_uniform(world: int) -> None:
    from repro_torch.core.overlap import exact_union_size
    from repro_torch.core.sharding import make_sampler_mesh
    from repro_torch.core.union_sampler import SetUnionSampler
    from repro_torch.data.workloads import uq1, uq4
    mesh = make_sampler_mesh(world=world, device="cpu")
    uq1_2 = uq1(scale=0.05, overlap=0.5, seed=1, n_joins=2)
    for wl, plan, mode in ((uq1_2, "static", "device"),
                           (uq1_2, "static", "host"),
                           (uq1_2, "adaptive", "device"),
                           (uq4(scale=0.02, seed=0), "static", "device")):
        est = _exact_cover(wl)
        U = exact_union_size(wl.cat, wl.joins)
        s = SetUnionSampler(wl.cat, wl.joins, est.cover, seed=11,
                            round_batch=512, mesh=mesh, plan=plan,
                            fused_rounds=mode)
        N = 120 * U
        ss = s.sample(N)
        assert len(ss) == N
        p = _chi2_p(ss.matrix(), U)
        assert p > 1e-3, (wl.joins[0].name, p)
        mm = s.prober.membership_matrix(ss.rows, s.order)
        assert np.array_equal(np.argmax(mm, axis=1), ss.home)
        _same_on_every_rank(np.concatenate([ss.matrix(), ss.home[:, None]],
                                           axis=1), world)
        if wl.joins[0].name.startswith("UQ1"):
            # the reference's bar: the host engine's piece marginals
            plain = SetUnionSampler(wl.cat, wl.joins, est.cover, seed=3,
                                    backend="numpy").sample(8000)
            fa = np.bincount(plain.home, minlength=2) / len(plain)
            fb = np.bincount(ss.home, minlength=2) / len(ss)
            assert np.abs(fa - fb).max() < 0.03, (fa, fb)


def check_device_loop(world: int) -> None:
    """``fused_rounds="device"`` (per-rank banks, the gated step run in
    chunks): every rank returns the same ``SampleSet`` and counters, one
    host sync per chunk plus the fetch, rows in their home piece and no
    earlier one; forced chunks and small banks (pushes and drains on every
    rank) included, over calls that cross capacity classes."""
    from repro_torch.core.sharding import make_sampler_mesh
    from repro_torch.core.union_sampler import SetUnionSampler
    from repro_torch.data.workloads import uq1
    mesh = make_sampler_mesh(world=world, device="cpu")
    wl = uq1(scale=0.05, overlap=0.5, seed=1, n_joins=3)
    est = _exact_cover(wl)
    for plan, chunk in (("static", None), ("adaptive", 3)):
        s = SetUnionSampler(wl.cat, wl.joins, est.cover, seed=4,
                            round_batch=256, mesh=mesh, plan=plan)
        eng = s.engine
        assert eng.fused_rounds == "device" and eng._bank_cap() == \
            max(1, eng.surplus_cap // world)
        eng.chunk_rounds = chunk
        for n in (700, 2500, 300):
            ss = s.sample(n)
            assert len(ss) == n
            assert eng.last_host_syncs == eng.last_chunks + 1
            mm = s.prober.membership_matrix(ss.rows, s.order)
            assert np.array_equal(np.argmax(mm, axis=1), ss.home)
            _same_on_every_rank(np.concatenate(
                [ss.matrix(), ss.home[:, None]], axis=1), world)
            _same_on_every_rank(np.array(
                list(ss.stats.as_dict().values())
                + [eng.last_rounds, eng.last_chunks]), world)
        _same_on_every_rank(eng.piece_stats, world)
        # the banks are per rank: together they hold the global count
        cnt = eng._state.count.clone()
        dist.all_reduce(cnt)
        if plan == "adaptive":
            assert torch.equal(cnt, eng._state.gcount)
        assert int(eng.piece_stats[:, 3].sum()) > 0     # banks drained


def check_online(world: int) -> None:
    from repro_torch.core.online import OnlineUnionSampler
    from repro_torch.core.sharding import make_sampler_mesh
    from repro_torch.data.workloads import uq1
    wl = uq1(scale=0.05, overlap=0.5, seed=1, n_joins=2)
    mesh = make_sampler_mesh(world=world, device="cpu")
    ou = OnlineUnionSampler(wl.cat, wl.joins, seed=5, phi=512, rw_batch=64,
                            mesh=mesh)
    out = ou.sample(100)
    assert len(out) == 100
    counts = {k: v.count for k, v in ou.estimator.size_stats.items()}
    assert counts and all(c % (world * 64) == 0 and c > 0
                          for c in counts.values()), counts
    _same_on_every_rank(out.matrix(), world)


def trace_audit_ranks(world: int) -> None:
    """``repro_torch.analysis.trace_audit.audit_sharded`` on every rank: one
    round of the sharded device loop is the per-rank round (the
    fingerprint exchange's all_gather and reduce_scatter) plus one banking
    all_gather, one round of its host loop the same per-rank round plus
    one all_gather of the matrices; both plans."""
    from repro_torch.analysis.trace_audit import audit_sharded
    for plan in ("static", "adaptive"):
        findings, report = audit_sharded(world, f"w{world}-{plan}", plan=plan,
                                         device="cpu")
        assert findings == [], [f.render() for f in findings]
        assert report["local_collectives"] == ["all-gather", "reduce-scatter"]
        assert report["collectives"] == report["host_collectives"] == [
            "all-gather", "reduce-scatter", "all-gather"]


def world2(world: int) -> None:
    check_exchange(world)
    check_moment_merge(world)
    check_device_loop(world)


def world4(world: int) -> None:
    check_exchange(world)
    check_moment_merge(world)
    check_uniform(world)
    check_device_loop(world)
    check_online(world)


# moe_ffn_dist's case (tests/test_infra.py:331-346): 8 experts over 4 model
# ranks, 4 sequences over 2 data ranks, capacity factor 16 (dropless)
MOE_DIST_DIMS = dict(d_model=32, n_experts=8, top_k=2, d_ff=64,
                     capacity_factor=16.0)
MOE_DIST_MESHES = {"d2m4": ((2, 4), ("data", "model")),
                   "p2d2m2": ((2, 2, 2), ("pod", "data", "model"))}
# forward_train under a mesh: a model whose MoE layers take moe_ffn_dist
# (8 experts over 4 model ranks) beside replicated attention, norms and
# arctic's dense residual FFN
FT_ARCH, FT_MESH, FT_SHAPE = "arctic-480b", "d2m4", (4, 32)


def _tensor_same_on_every_rank(world: int, t: torch.Tensor, what: str
                               ) -> None:
    g = torch.empty(world * t.numel(), dtype=t.dtype)
    dist.all_gather_into_tensor(g, t.reshape(-1).contiguous())
    g = g.view(world, -1)
    assert all(torch.equal(g[0], g[r]) for r in range(world)), what


def model_sharding(world: int, io_dir: str) -> None:
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import (ambient_mesh, axis_index,
                                         make_debug_mesh, make_mesh,
                                         set_mesh)
    from repro_torch.launch.sharding import batch_sharding, tree_shardings
    from repro_torch.models.moe import MoEDims, moe_ffn_dist
    rank = dist.get_rank()
    mesh = make_debug_mesh(data=2, model=4)
    assert axis_index(mesh, ("data", "model")) == rank
    meta = {"w": torch.empty((8, 32, 64), device="meta"),
            "b": torch.empty((7, 64), device="meta")}
    sh = tree_shardings(mesh, meta, {"w": ("experts", "embed", "mlp"),
                                     "b": ("batch", "mlp")})
    # experts on "model", d on "data" (FSDP); the batch of 7 stays whole
    assert sh["w"].placements == (Shard(1), Shard(0)), sh["w"]
    assert sh["b"].placements == (Replicate(), Shard(1)), sh["b"]
    assert batch_sharding(mesh, 8).placements == (Shard(0), Replicate())

    z = np.load(os.path.join(io_dir, "inputs.npz"))
    dims = MoEDims(**MOE_DIST_DIMS)
    ct = torch.as_tensor(z["ct"])
    out = {}
    for name, (shape, axes) in MOE_DIST_MESHES.items():
        mesh = make_mesh(shape, axes)
        params = {k: torch.tensor(z[k], requires_grad=True)
                  for k in ("router", "w_gate", "w_up", "w_down")}
        x = torch.tensor(z["x"], requires_grad=True)
        with set_mesh(mesh):
            o, aux = moe_ffn_dist(params, x, dims)
        assert ambient_mesh() is None
        ((o * ct).sum() + 0.01 * aux).backward()
        res = {"out": o.detach(), "aux": aux.detach()[None]}
        res.update({f"grad.{k}": t.grad for k, t in {**params, "x": x}.items()})
        for k, v in res.items():
            _tensor_same_on_every_rank(world, v, f"{name}.{k}")
            out[f"{name}.{k}"] = v.numpy()
    out.update(_forward_train_under_mesh(world, z))
    if rank == 0:
        np.savez(os.path.join(io_dir, "port.npz"), **out)


def _forward_train_under_mesh(world: int, z) -> dict:
    """``forward_train`` of ``FT_ARCH``'s float32 smoke config on the
    ``FT_MESH`` mesh: loss, metrics and every parameter's gradient (the
    same on every rank), keyed ``ft.*``; every MoE layer must have taken
    ``moe_ffn_dist``."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.interop import params_from_numpy
    from repro_torch.launch.mesh import make_mesh, set_mesh
    from repro_torch.models import moe, transformer
    cfg = dataclasses.replace(configs.get_smoke_config(FT_ARCH),
                              dtype="float32")
    names = [k[len("ft.param."):] for k in z.files
             if k.startswith("ft.param.")]
    params = params_from_numpy(cfg, {k: z["ft.param." + k] for k in names},
                               device="cpu", dtype=torch.float32)
    params = {k: v.requires_grad_(True) for k, v in params.items()}
    batch = {k: torch.as_tensor(z["ft." + k]) for k in ("tokens", "targets")}
    calls, dist_fn = [], moe.moe_ffn_dist

    def counted(*a):
        calls.append(1)
        return dist_fn(*a)
    moe.moe_ffn_dist = counted
    try:
        with set_mesh(make_mesh(*MOE_DIST_MESHES[FT_MESH])):
            loss, met = transformer.forward_train(params, cfg, batch)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        materialize_grads=True)
    finally:
        moe.moe_ffn_dist = dist_fn
    assert len(calls) >= cfg.n_layers, calls
    out = {"ft.total": loss.detach()[None]}
    out.update({f"ft.{k}": v.detach().reshape(1) for k, v in met.items()})
    out.update({f"ft.grad.{k}": g for k, g in zip(params, grads)})
    for k, v in out.items():
        _tensor_same_on_every_rank(world, v, k)
    return {k: v.numpy() for k, v in out.items()}


def compressed_psum_ranks(world: int, io_dir: str) -> None:
    from repro_torch.launch.mesh import axis_group, make_mesh
    from repro_torch.train.grad_compress import compressed_psum
    rank = dist.get_rank()
    mesh = make_mesh((world,), ("pod",))
    z = np.load(os.path.join(io_dir, "inputs.npz"))
    got = compressed_psum(torch.as_tensor(z[f"c{rank}"]),
                          axis_group(mesh, "pod"))
    g = torch.empty(world * got.numel())
    dist.all_gather_into_tensor(g, got.reshape(-1))
    g = g.view(world, -1)
    assert all(torch.equal(g[0], g[r]) for r in range(world))
    if rank == 0:
        np.save(os.path.join(io_dir, "psum.npy"), got.numpy())
