"""The port's model sharding against the JAX package: the meshes
(``launch/mesh.py``), the logical-axis rules (``launch/sharding.py``), the
train state's shapes and logical axes, the expert-parallel ``moe_ffn_dist``
and ``compressed_psum``.

* ``rules``/``spec_for`` for every parameter and cache entry of every
  config on the production meshes, (16, 16) and (2, 16, 16), described by
  axis names and sizes (no 256 ranks): the reference gets a plain mesh stub
  with ``.shape`` and ``.axis_names``; the specs must be equal;
* ``train_state_specs`` (shapes and dtypes, on the meta device) and
  ``train_state_logical_axes`` for AdamW, Adafactor (arctic,
  mistral-large) and ``compress_grads``: equal;
* ``moe_ffn_auto`` takes the distributed path exactly where the reference
  does;
* one spawn of 8 gloo ranks (``test_torch_mesh_support.model_sharding``):
  ``tree_shardings``' DTensor placements on a ``DeviceMesh``, and
  ``moe_ffn_dist`` on (data 2 × model 4) and (pod 2 × data 2 × model 2)
  over the reference's test inputs (``tests/test_infra.py:331-346``)
  against the reference's ``moe_ffn_dist``, run in one subprocess with 8
  forced host devices as ``test_infra.py`` runs it: outputs and aux within
  2e-5 (the reference's own bar against the dense path), every rank's
  gradients (the same on every rank: the reference's whole gradient, as
  under ``shard_map``) within 1e-5 of the tensor's largest value; and
  against ``moe_ffn`` with ``capacity=64``: outputs within 2e-5, the
  expert weights' gradients within 1e-5 of their largest value (the
  router's and x's differ by the per-shard aux, as the reference's do);
  and ``forward_train`` of arctic's float32 smoke config under the (2, 4)
  mesh, its MoE layers through ``moe_ffn_dist`` beside the replicated
  rest of the model, against the reference's under the same mesh: loss
  and metrics within rtol 1e-4, every rank's gradient of every parameter
  within rtol 1e-4 and 1e-5 of the tensor's largest value;
* one spawn of 4 gloo ranks: ``compressed_psum`` over a one-axis mesh
  equal to the reference's under ``shard_map`` on the same per-rank
  inputs (float32 rounding of the same sum: 1e-6 of the largest value),
  and within the reference's bar of the exact sum (``err ≤ 0.05·max|psum|
  + 1e-5``).
"""

import dataclasses
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.launch import mesh as rmesh
from repro.launch import sharding as rsharding
from repro.models import moe as rmoe
from repro.models import serve as rserve
from repro.models import transformer as rtrans
from repro.train import grad_compress as rgc
from repro.train import optimizer as ropt
from repro.train import train_step as rstep

from repro_torch import configs as pconfigs
from repro_torch.launch import mesh as pmesh
from repro_torch.launch import sharding as psharding
from repro_torch.models import moe as pmoe
from repro_torch.models import serve as pserve
from repro_torch.train import grad_compress as pgc
from repro_torch.train import optimizer as popt
from repro_torch.train import train_step as pstep

from test_torch_mesh_support import (FT_ARCH, FT_MESH, FT_SHAPE,
                                     MOE_DIST_DIMS, MOE_DIST_MESHES, spawn)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_ARCHS = rconfigs.ASSIGNED_ARCHS + ["unionlm-100m"]
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}
OUT_TOL, GRAD_TOL = 2e-5, 1e-5


def _stub(shape, axes):
    return types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 axis_names=tuple(axes))


def _meshes(kind):
    shape, axes = MESHES[kind]
    return _stub(shape, axes), pmesh.AbstractMesh(shape, axes)


# ---------------------------------------------------------------------------
# meshes, rules and specs
# ---------------------------------------------------------------------------


def test_mesh_descriptions_and_axes_equal_reference():
    for multi_pod, kind in ((False, "pod"), (True, "multi_pod")):
        am = pmesh.production_mesh_shape(multi_pod=multi_pod)
        ref, _ = _meshes(kind)
        assert am.shape == ref.shape and am.axis_names == ref.axis_names
        assert am.size == (512 if multi_pod else 256)
        assert pmesh.data_axes(am) == rmesh.data_axes(ref)
        assert pmesh.model_axes(am) == rmesh.model_axes(ref)
    assert pmesh.ambient_mesh() is None
    am = pmesh.AbstractMesh((2, 4), ("data", "model"))
    with pmesh.set_mesh(am):
        assert pmesh.ambient_mesh() is am
        with pmesh.set_mesh(pmesh.AbstractMesh((8,), ("data",))):
            assert pmesh.model_axes(pmesh.ambient_mesh()) == ()
        assert pmesh.ambient_mesh() is am
    assert pmesh.ambient_mesh() is None
    with pytest.raises(RuntimeError, match="process group of 8 ranks"):
        pmesh.make_mesh((2, 4), ("data", "model"))
    with pytest.raises(TypeError):
        pmesh.axis_group(am, "model")


@pytest.mark.parametrize("kind", list(MESHES))
def test_spec_for_every_param_and_cache_entry_equals_reference(kind):
    ref_mesh, mesh = _meshes(kind)
    n = 0
    for arch in ALL_ARCHS:
        rc, pc = rconfigs.get_config(arch), pconfigs.get_config(arch)
        entries = {("param", k): v
                   for k, v in rtrans.param_entries(rc).items()}
        for batch, max_len in ((128, 32768), (1, 524288), (3, 4096)):
            want = rserve.cache_entries(rc, batch, max_len)
            assert pserve.cache_entries(pc, batch, max_len) == want
            entries.update({("cache", batch, max_len, k): v
                            for k, v in want.items()})
        for sharded in (True, False):
            rr = rsharding.rules(ref_mesh, batch_sharded=sharded)
            pr = psharding.rules(mesh, batch_sharded=sharded)
            assert pr == rr
            for key, (shape, logical) in entries.items():
                got = psharding.spec_for(mesh, shape, logical, pr)
                want = rsharding.spec_for(ref_mesh, shape, logical, rr)
                assert isinstance(got, psharding.PartitionSpec)
                assert tuple(got) == tuple(want), (arch, key, got, want)
                n += 1
    assert n > 400


@pytest.mark.parametrize("kind", list(MESHES))
def test_batch_and_frontend_shardings_equal_reference(kind):
    shape, axes = MESHES[kind]
    ref_mesh = jax.sharding.AbstractMesh(shape, axes)
    _, mesh = _meshes(kind)
    for batch in (1, 16, 32, 256):
        for pf, rf in ((psharding.batch_sharding, rsharding.batch_sharding),
                       (psharding.frontend_sharding,
                        rsharding.frontend_sharding)):
            assert tuple(pf(mesh, batch).spec) == tuple(rf(ref_mesh,
                                                           batch).spec)
        assert psharding.batch_is_sharded(mesh, batch) == \
            rsharding.batch_is_sharded(ref_mesh, batch)
    assert tuple(psharding.replicated(mesh).spec) == ()
    sh = psharding.batch_sharding(mesh, 512)
    assert sh.placements == ((torch.distributed.tensor.Shard(0),)
                             * (len(axes) - 1)
                             + (torch.distributed.tensor.Replicate(),))


@pytest.mark.parametrize("arch,kind,m_dtype,compress", [
    ("unionlm-100m", "adamw", "float32", False),
    ("phi3.5-moe-42b-a6.6b", "adamw", "bfloat16", True),
    ("zamba2-7b", "adamw", "float32", True),
    ("arctic-480b", "adafactor", "float32", False),
    ("mistral-large-123b", "adafactor", "float32", True),
    ("whisper-medium", "adafactor", "bfloat16", False)])
def test_train_state_specs_and_axes_equal_reference(arch, kind, m_dtype,
                                                    compress):
    """Shapes and dtypes on the meta device, and logical axes, of the
    whole state at full size; their shardings on the multi-pod mesh."""
    rc, pc = rconfigs.get_config(arch), pconfigs.get_config(arch)
    rtc = rstep.TrainConfig(opt=ropt.OptConfig(kind=kind, m_dtype=m_dtype),
                            compress_grads=compress)
    ptc = pstep.TrainConfig(opt=popt.OptConfig(kind=kind, m_dtype=m_dtype),
                            compress_grads=compress)
    want = rstep.train_state_specs(rc, rtc)
    got = pstep.train_state_specs(pc, ptc)
    assert set(got) == set(want)
    assert got["step"].device.type == "meta"
    assert tuple(got["step"].shape) == () and got["step"].dtype == torch.int32
    for part in set(want) - {"step"}:
        assert set(got[part]) == set(want[part]), part
        for k, t in got[part].items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[part][k].shape), (part, k)
            assert str(t.dtype).split(".")[1] == str(want[part][k].dtype)
    wax = rstep.train_state_logical_axes(rc, rtc)
    gax = pstep.train_state_logical_axes(pc, ptc)
    assert gax == wax
    ref_mesh, mesh = _meshes("multi_pod")
    for part in set(want) - {"step"}:
        sh = psharding.tree_shardings(mesh, got[part], gax[part])
        r = rsharding.rules(ref_mesh)
        for k, s in sh.items():
            assert tuple(s.spec) == tuple(rsharding.spec_for(
                ref_mesh, tuple(want[part][k].shape), wax[part][k], r)), k


def test_moe_ffn_auto_takes_the_dist_path_where_the_reference_does(
        monkeypatch):
    calls = []
    for mod, tag in ((rmoe, "ref"), (pmoe, "port")):
        monkeypatch.setattr(mod, "moe_ffn_dist",
                            lambda p, x, d, tag=tag: calls.append(
                                (tag, "dist")))
        monkeypatch.setattr(mod, "moe_ffn",
                            lambda p, x, d, tag=tag: calls.append(
                                (tag, "dense")))
    cases = [((2, 4), ("data", "model"), 8, 4),    # dist
             ((2, 4), ("data", "model"), 6, 4),    # experts % model
             ((2, 4), ("data", "model"), 8, 3),    # batch % data
             ((8, 1), ("data", "model"), 8, 8),    # model of one
             ((2, 2, 2), ("pod", "data", "model"), 4, 4),
             ((2, 2, 2), ("pod", "data", "model"), 4, 6),
             ((8,), ("data",), 8, 8), None]
    want = []
    for case in cases:
        E, B = (4, 4) if case is None else case[2:]
        dims = rmoe.MoEDims(16, E, 2, 32)
        x = types.SimpleNamespace(shape=(B, 8, 16))
        calls.clear()
        monkeypatch.setattr(rmoe, "_ambient_mesh",
                            lambda c=case: None if c is None
                            else _stub(c[0], c[1]))
        rmoe.moe_ffn_auto({}, x, dims)
        if case is None:
            pmoe.moe_ffn_auto({}, x, dims)
        else:
            with pmesh.set_mesh(pmesh.AbstractMesh(case[0], case[1])):
                pmoe.moe_ffn_auto({}, x, dims)
        assert calls[0] == ("ref", calls[1][1]) and calls[1][0] == "port"
        want.append(calls[1][1])
    assert want == ["dist", "dense", "dense", "dense", "dist", "dense",
                    "dense", "dense"]


# ---------------------------------------------------------------------------
# moe_ffn_dist and compressed_psum over gloo ranks
# ---------------------------------------------------------------------------

_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro.launch.mesh import make_mesh, set_mesh, shard_map
from repro.models.moe import MoEDims, moe_ffn, moe_ffn_dist
from repro.train.grad_compress import compressed_psum
from repro import configs
from repro.models import transformer
io, dims, meshes = sys.argv[1], eval(sys.argv[2]), eval(sys.argv[3])
ft_arch, ft_mesh = sys.argv[4], sys.argv[5]
z = np.load(os.path.join(io, "inputs.npz"))
dims = MoEDims(**dims)
params = {k: jnp.asarray(z[k]) for k in ("router", "w_gate", "w_up",
                                         "w_down")}
x, ct = jnp.asarray(z["x"]), jnp.asarray(z["ct"])
out = {}

def run(name, fn):
    def loss(p, x):
        o, aux = fn(p, x)
        return jnp.sum(o * ct) + 0.01 * aux
    o, aux = jax.jit(fn)(params, x)
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, x)
    out[name + ".out"], out[name + ".aux"] = np.asarray(o), np.asarray(aux)
    for k, v in {**gp, "x": gx}.items():
        out[name + ".grad." + k] = np.asarray(v)

run("dense", lambda p, x: moe_ffn(p, x, dims, capacity=64))
for name, (shape, axes) in meshes.items():
    with set_mesh(make_mesh(shape, axes)):
        run(name, lambda p, x: moe_ffn_dist(p, x, dims))
import dataclasses
cfg = dataclasses.replace(configs.get_smoke_config(ft_arch), dtype="float32")
fp = {k[len("ft.param."):]: jnp.asarray(z[k]) for k in z.files
      if k.startswith("ft.param.")}
fb = {k: jnp.asarray(z["ft." + k]) for k in ("tokens", "targets")}
with set_mesh(make_mesh(*meshes[ft_mesh])):
    (loss, met), g = jax.jit(jax.value_and_grad(
        lambda p, b: transformer.forward_train(p, cfg, b), has_aux=True))(
            fp, fb)
out["ft.total"] = np.asarray(loss)
for k, v in met.items():
    out["ft." + k] = np.asarray(v)
for k, v in g.items():
    out["ft.grad." + k] = np.asarray(v)
m4 = Mesh(np.array(jax.devices()[:4]), ("pod",))
cs = jnp.asarray(np.stack([z["c%d" % r] for r in range(4)]))
ps = shard_map(lambda v: compressed_psum(v[0], "pod")[None], mesh=m4,
               in_specs=P("pod"), out_specs=P("pod"))
out["psum"] = np.asarray(jax.jit(ps)(cs))
np.savez(os.path.join(io, "ref.npz"), **out)
print("OK")
"""


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """The reference's subprocess, then one spawn of 8 ranks and one of 4,
    on the same inputs; (reference, port, port psum, inputs)."""
    io = str(tmp_path_factory.mktemp("model_sharding"))
    rng = np.random.default_rng(0)
    dims = rmoe.MoEDims(**MOE_DIST_DIMS)
    inputs = {k: (rng.standard_normal(s) * 0.1).astype(np.float32)
              for k, s in rmoe.moe_param_shapes(dims).items()}
    inputs["x"] = rng.standard_normal((4, 16, 32)).astype(np.float32)
    inputs["ct"] = rng.standard_normal((4, 16, 32)).astype(np.float32)
    for r in range(4):
        inputs[f"c{r}"] = (rng.standard_normal((64, 48))
                           * 10.0 ** (r - 2)).astype(np.float32)
    rc = dataclasses.replace(rconfigs.get_smoke_config(FT_ARCH),
                             dtype="float32")
    for k, v in rtrans.init_params(rc, seed=0).items():
        inputs["ft.param." + k] = np.asarray(v, np.float32)
    inputs["ft.tokens"] = rng.integers(4, rc.vocab, FT_SHAPE).astype(np.int32)
    inputs["ft.targets"] = rng.integers(0, rc.vocab, FT_SHAPE).astype(
        np.int32)
    np.savez(os.path.join(io, "inputs.npz"), **inputs)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, io, repr(MOE_DIST_DIMS),
         repr(MOE_DIST_MESHES), FT_ARCH, FT_MESH], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0 and "OK" in proc.stdout, proc.stderr[-3000:]
    spawn("model_sharding", 8, 180.0, io)
    spawn("compressed_psum_ranks", 4, 120.0, io)
    return (dict(np.load(os.path.join(io, "ref.npz"))),
            dict(np.load(os.path.join(io, "port.npz"))),
            np.load(os.path.join(io, "psum.npy")), inputs)


def _close(got, want, tol, what):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


@pytest.mark.parametrize("mesh", list(MOE_DIST_MESHES))
def test_moe_ffn_dist_at_world_8_equals_reference(gloo_runs, mesh):
    ref, port, _, _ = gloo_runs
    np.testing.assert_allclose(port[f"{mesh}.out"], ref[f"{mesh}.out"],
                               rtol=0, atol=OUT_TOL)
    np.testing.assert_allclose(port[f"{mesh}.aux"][0], ref[f"{mesh}.aux"],
                               rtol=1e-6)
    for k in ("router", "w_gate", "w_up", "w_down", "x"):
        _close(port[f"{mesh}.grad.{k}"], ref[f"{mesh}.grad.{k}"], GRAD_TOL,
               k)


@pytest.mark.parametrize("mesh", list(MOE_DIST_MESHES))
def test_moe_ffn_dist_at_world_8_equals_dense_moe_ffn(gloo_runs, mesh):
    """Dropless on both sides, so the same outputs and expert gradients;
    the aux is the per-shard Switch aux averaged over the data axes, so
    it, and the router's and x's gradients through it, differ from the
    dense ones (as the reference's do)."""
    ref, port, _, _ = gloo_runs
    np.testing.assert_allclose(port[f"{mesh}.out"], ref["dense.out"],
                               rtol=0, atol=OUT_TOL)
    assert port[f"{mesh}.aux"][0] != pytest.approx(float(ref["dense.aux"]),
                                                   rel=1e-4)
    for k in ("w_gate", "w_up", "w_down"):
        _close(port[f"{mesh}.grad.{k}"], ref["dense.grad." + k], GRAD_TOL, k)


def test_forward_train_under_a_mesh_equals_reference(gloo_runs):
    """The MoE layers' gradients meet the replicated rest of the model
    (residuals, norms, attention, arctic's dense FFN, the loss): every
    rank holds the reference's whole gradient of every parameter."""
    ref, port, _, _ = gloo_runs
    for k in ("total", "loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(port[f"ft.{k}"][0], ref[f"ft.{k}"],
                                   rtol=1e-4, err_msg=k)
    assert float(ref["ft.aux_loss"]) > 0
    names = [k for k in ref if k.startswith("ft.grad.")]
    assert names and set(names) == {k for k in port
                                    if k.startswith("ft.grad.")}
    for k in names:
        want = ref[k]
        np.testing.assert_allclose(port[k], want, rtol=1e-4,
                                   atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg=k)


def test_compressed_psum_at_world_4_equals_reference(gloo_runs):
    ref, _, psum, inputs = gloo_runs
    want = ref["psum"]
    assert all(np.array_equal(want[0], want[r]) for r in range(4))
    np.testing.assert_allclose(psum, want[0], rtol=0,
                               atol=1e-6 * np.abs(want[0]).max())
    exact = sum(inputs[f"c{r}"].astype(np.float64) for r in range(4))
    assert np.abs(psum - exact).max() <= 0.05 * np.abs(exact).max() + 1e-5


def test_compressed_psum_of_one_rank_equals_reference():
    x = np.random.default_rng(1).standard_normal((16, 8)).astype(np.float32)
    got = pgc.compressed_psum(torch.as_tensor(x))
    q, s = rgc._quant_int8(jax.numpy.asarray(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(rgc._dequant(q, s)))
