"""The port's training path against the JAX package: the attention
backward, ``forward_train``, the optimizers, the schedule and clipping,
gradient compression, whole train steps and μ-batch accumulation
(``dense`` and ``gemma2``).

Both packages get the same inputs: numpy arrays from seeded generators,
and the reference's ``init_params``/``init_train_state`` carried into the
port by ``repro_torch.interop`` (``params_from_numpy``,
``train_state_from_numpy``).  Limits, on the smoke configs:

* float32 values (losses, attention outputs): rtol 1e-4, atol 1e-4, as in
  ``tests/test_torch_models.py`` (the two differ in the order of float32
  sums; measured ~1e-6 relative);
* float32 gradients: rtol 1e-4 and atol 1e-5 × max|g| of the tensor
  (measured ≤ 1.6e-6 × max|g|);
* bf16 (the configs' own dtype): the loss within rtol 1e-2 (measured
  8e-5), and per gradient tensor correlation > 0.99 and the largest
  difference at most 5 % of the largest reference value (bf16 rounds at
  other points in XLA and in torch; measured ≥ 0.9998 and ≤ 2.2 %);
* the optimizers, the schedule, clipping and compression on shared
  inputs: rtol 1e-6, atol 1e-7 (the same float32 arithmetic; only
  Adafactor's row and column means differ in summation order, measured
  2e-7 of the largest slot);
* a whole float32 train step, twice: loss, grad-norm and lr as float32
  values; the optimizer slots as gradients.  The parameters: Adam's first
  step moves each element by ``lr·g/(|g| + eps)``, so an element whose
  gradient is near 0 and differs in sign between XLA and torch (within the
  gradient limit) moves by ±lr in opposite directions.  Hence every element
  within the sum of the steps' 2·lr of the reference, and at least 99.9 %
  of them within rtol 1e-4 and atol 1e-6 (measured: 4 of 106,816 elements
  outside, by at most 5.2e-5 at lr 1e-3).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import layers as rlayers
from repro.models import transformer as rtrans
from repro.train import grad_compress as rgc
from repro.train import optimizer as ropt
from repro.train import train_step as rstep

from repro_torch import configs as pconfigs
from repro_torch.interop import params_from_numpy, train_state_from_numpy
from repro_torch.models import layers as players
from repro_torch.models import transformer as ptrans
from repro_torch.train import grad_compress as pgc
from repro_torch.train import optimizer as popt
from repro_torch.train import train_step as pstep

F32 = {"rtol": 1e-4, "atol": 1e-4}
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
BF16_CORR, BF16_REL, BF16_LOSS_RTOL = 0.99, 0.05, 1e-2
SHARED = {"rtol": 1e-6, "atol": 1e-7}
STEP_RTOL, STEP_ATOL, STEP_SHARE = 1e-4, 1e-6, 0.999
ARCHS = ["unionlm-100m", "gemma2-9b"]


def _grad_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL * np.abs(want).max(),
                               err_msg=what)


def _close_bf16(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rel = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert rel <= BF16_REL, (what, rel)
    if want.size > 1 and want.std() > 0:
        corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
        assert corr > BF16_CORR, (what, corr)


@functools.lru_cache(maxsize=None)
def _cfgs(arch, dtype):
    rc = dataclasses.replace(rconfigs.get_smoke_config(arch), dtype=dtype)
    pc = dataclasses.replace(pconfigs.get_smoke_config(arch), dtype=dtype)
    return rc, pc


def _batch(cfg, B=2, S=64, seed=2):
    """Tokens in [4, vocab); targets in [0, vocab) (some PAD = 0)."""
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(4, cfg.vocab, (B, S)).astype(np.int32),
            "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the attention backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,window,cap,prefix", [
    (True, 0, 0.0, 0), (True, 24, 30.0, 0), (True, 0, 0.0, 16),
    (True, 20, 0.0, 8), (False, 0, 0.0, 0)])
def test_flash_attention_cv_grads_equal_reference(causal, window, cap,
                                                  prefix):
    """dq, dk, dv of ``flash_attention_cv`` (GQA, G = 3) against the
    reference's custom VJP, for a cotangent from a seeded generator."""
    rng = np.random.default_rng(5)
    B, S, H, KV, D = 2, 64, 6, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    do = rng.standard_normal((B, S, H, D)).astype(np.float32)
    args = (causal, window, cap, 16, 32, prefix)

    def f(q, k, v):
        return jnp.sum(rlayers.flash_attention_cv(q, k, v, *args) * do)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = players.flash_attention_cv(tq, tk, tv, *args)
    (o * torch.as_tensor(do)).sum().backward()
    np.testing.assert_allclose(
        o.detach().numpy(),
        np.asarray(rlayers.flash_attention_cv(*map(jnp.asarray, (q, k, v)),
                                              *args)), **F32)
    for name, got, w in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        _grad_close(got.numpy(), w, f"d{name}")


def test_tile_kind_matches_the_mask():
    """The tiles the attention skips (dead) or leaves unmasked (full) are
    exactly those whose ``_mask_for`` mask is all False or all True."""
    rng = np.random.default_rng(0)
    for _ in range(400):
        q0, k0 = (int(x) for x in rng.integers(0, 80, 2))
        q1, k1 = q0 + int(rng.integers(1, 40)), k0 + int(rng.integers(1, 40))
        causal = bool(rng.integers(0, 2))
        window, prefix = (int(rng.choice([0, 1, 7, 30])),
                          int(rng.choice([0, 5, 50])))
        mask = players._mask_for(torch.arange(q0, q1), torch.arange(k0, k1),
                                 causal, window, prefix)
        kind = players._tile_kind(q0, q1, k0, k1, causal, window, prefix)
        assert kind == ("full" if bool(mask.all()) else "partial"
                        if bool(mask.any()) else "dead") or (
            kind == "partial" and bool(mask.all())), (q0, q1, k0, k1,
                                                      causal, window, prefix)


def test_backward_goes_through_the_autograd_function(monkeypatch):
    """The attention saves only (q, k, v, o, lse) and its backward runs the
    Function's recompute backward once per layer, remat included."""
    from torch.autograd.graph import saved_tensors_hooks
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(rng.standard_normal(s).astype(np.float32),
                            requires_grad=True)
               for s in ((2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16)))
    saved = []
    with saved_tensors_hooks(lambda t: saved.append(t.shape) or t,
                             lambda t: t):
        players.flash_attention_cv(q, k, v, True, 0, 0.0, 16, 16, 0)
    assert saved == [q.shape, k.shape, v.shape, q.shape, q.shape[:3]]

    calls = [0]
    real = players._flash_bwd

    def counted(*a):
        calls[0] += 1
        return real(*a)
    monkeypatch.setattr(players, "_flash_bwd", counted)
    _, pc = _cfgs("gemma2-9b", "float32")
    assert pc.remat
    params = ptrans.init_params(pc, seed=0, device="cpu",
                                dtype=torch.float32)
    for t in params.values():
        t.requires_grad_(True)
    loss, _ = ptrans.forward_train(params, pc, _torch(_batch(pc)))
    loss.backward()
    assert calls[0] == pc.n_layers
    assert all(t.grad is not None for t in params.values())


# ---------------------------------------------------------------------------
# forward_train: loss and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_equals_reference(arch, dtype):
    """Loss, metrics and the gradient of every parameter, differentiated
    with respect to compute-dtype copies of the parameters (the train
    step's ``p16``)."""
    rc, pc = _cfgs(arch, dtype)
    rp = rtrans.init_params(rc, seed=0)
    batch = _batch(rc)
    p16 = {k: v.astype(rc.compute_dtype) for k, v in rp.items()}
    (rloss, rmet), rgrads = jax.jit(jax.value_and_grad(
        lambda p, b: rtrans.forward_train(p, rc, b), has_aux=True))(
            p16, _jax(batch))
    masters = params_from_numpy(pc, {k: np.asarray(v) for k, v in rp.items()},
                                device="cpu", dtype=torch.float32)
    t16 = {k: v.to(pc.compute_dtype).requires_grad_(True)
           for k, v in masters.items()}
    loss, met = ptrans.forward_train(t16, pc, _torch(batch))
    grads = dict(zip(t16, torch.autograd.grad(loss, list(t16.values()))))
    loss = loss.detach()
    assert float(met["tokens"]) == float(rmet["tokens"]) == float(
        (batch["targets"] != 0).sum())
    assert float(met["aux_loss"]) == 0.0
    if dtype == "float32":
        np.testing.assert_allclose(float(loss), float(rloss), **F32)
    else:
        np.testing.assert_allclose(float(loss), float(rloss),
                                   rtol=BF16_LOSS_RTOL)
    assert set(grads) == set(rgrads)
    for k, g in grads.items():
        assert g.dtype == pc.compute_dtype, k
        want = np.asarray(rgrads[k], np.float32)
        if dtype == "float32":
            _grad_close(g.numpy(), want, k)
        else:
            _close_bf16(g.float().numpy(), want, k)


# ---------------------------------------------------------------------------
# optimizers, schedule, clipping, compression on shared inputs
# ---------------------------------------------------------------------------

OPT_SHAPES = {"w": (8, 6), "blocks.w": (3, 5, 4), "norm": (6,)}


@pytest.mark.parametrize("kind,m_dtype", [("adamw", "float32"),
                                          ("adafactor", "float32"),
                                          ("adamw", "bfloat16")])
@pytest.mark.parametrize("piece", [7, 64])
def test_apply_update_pieces_equal_whole_tensors(kind, m_dtype, piece,
                                                 monkeypatch):
    """``apply_update_`` in pieces (flat ranges, or dim-0 rows of a
    factored 3-d tensor) writes the bits of the whole-tensor update, into
    the same tensors, over three steps."""
    rng = np.random.default_rng(1)
    shapes = dict(OPT_SHAPES, big=(4, 9, 5))
    po = popt.OptConfig(kind=kind, m_dtype=m_dtype, lr=1e-2)
    p = {k: torch.as_tensor(rng.standard_normal(s).astype(np.float32))
         for k, s in shapes.items()}
    ip = {k: v.clone() for k, v in p.items()}
    st = popt.init_opt_state(po, p)
    ist = {k: v.clone() for k, v in st.items()}
    ids = {k: v.data_ptr() for k, v in {**ip, **ist}.items()}
    for i in range(3):
        g = {k: torch.as_tensor((rng.standard_normal(s) * 10.0 ** (i - 1)
                                 ).astype(np.float32)).to(torch.bfloat16)
             for k, s in shapes.items()}
        lr = torch.tensor(1e-2 * (i + 1) / 3)
        step = torch.tensor(i, dtype=torch.int32)
        monkeypatch.setattr(popt, "UPDATE_PIECE", 1 << 25)
        popt.apply_update_(po, p, g, st, step, lr=lr)
        monkeypatch.setattr(popt, "UPDATE_PIECE", piece)
        assert popt.apply_update_(po, ip, g, ist, step, lr=lr) is None
    for k in p:
        assert torch.equal(ip[k], p[k]), k
    for k in st:
        assert ist[k].dtype == st[k].dtype and torch.equal(ist[k], st[k]), k
    assert ids == {k: v.data_ptr() for k, v in {**ip, **ist}.items()}


@pytest.mark.parametrize("kind,m_dtype", [("adamw", "float32"),
                                          ("adafactor", "float32"),
                                          ("adamw", "bfloat16")])
def test_optimizer_on_shared_gradients_equals_reference(kind, m_dtype):
    """Four optimizer steps (the reference's ``apply_update``, the port's
    in-place ``apply_update_``) on the same gradients (magnitudes from
    1e-3 to 10) and schedule values: parameters and every slot."""
    rng = np.random.default_rng(0)
    p = {k: rng.standard_normal(s).astype(np.float32)
         for k, s in OPT_SHAPES.items()}
    ro = ropt.OptConfig(kind=kind, m_dtype=m_dtype, lr=1e-2)
    po = popt.OptConfig(kind=kind, m_dtype=m_dtype, lr=1e-2)
    assert dataclasses.asdict(ro) == dataclasses.asdict(po)
    shapes = {k: v.shape for k, v in p.items()}
    assert ropt.opt_state_entries(ro, shapes) == popt.opt_state_entries(
        po, shapes)
    rp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    rs, ts = ropt.init_opt_state(ro, rp), popt.init_opt_state(po, tp)
    for i in range(4):
        g = {k: (rng.standard_normal(s) * 10 ** rng.uniform(-3, 1)
                 ).astype(np.float32) for k, s in OPT_SHAPES.items()}
        lr = np.float32(1e-2 * (i + 1) / 4)
        rp, rs = ropt.apply_update(ro, rp, {k: jnp.asarray(v)
                                            for k, v in g.items()},
                                   rs, jnp.asarray(i, jnp.int32),
                                   lr=jnp.asarray(lr))
        popt.apply_update_(po, tp, {k: torch.as_tensor(v)
                                    for k, v in g.items()},
                           ts, torch.tensor(i, dtype=torch.int32),
                           lr=torch.tensor(lr))
    for k in rp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(rp[k]),
                                   err_msg=k, **SHARED)
    assert set(ts) == set(rs)
    for k in rs:
        want = np.asarray(rs[k], np.float32)
        assert str(ts[k].dtype).split(".")[1] == str(rs[k].dtype), k
        np.testing.assert_allclose(ts[k].float().numpy(), want, err_msg=k,
                                   rtol=SHARED["rtol"],
                                   atol=SHARED["atol"] * np.abs(want).max())
    assert popt.default_opt_for("arctic-480b").kind == ropt.default_opt_for(
        "arctic-480b").kind == "adafactor"
    assert popt.default_opt_for("unionlm-100m") == popt.OptConfig()


def test_lr_schedule_and_clip_equal_reference():
    for warm, total in ((1, 10), (100, 10_000), (5, 5)):
        rtc = rstep.TrainConfig(warmup_steps=warm, total_steps=total)
        ptc = pstep.TrainConfig(warmup_steps=warm, total_steps=total)
        steps = np.unique(np.linspace(0, total + 3, 40).astype(np.int32))
        want = [float(rstep.lr_at(rtc, jnp.asarray(s))) for s in steps]
        got = [float(pstep.lr_at(ptc, torch.tensor(s))) for s in steps]
        np.testing.assert_allclose(got, want, **SHARED)
    rng = np.random.default_rng(3)
    for max_norm in (0.5, 1e3):
        g = {k: (rng.standard_normal(s)).astype(np.float32)
             for k, s in OPT_SHAPES.items()}
        rg, rn = ropt.clip_by_global_norm({k: jnp.asarray(v)
                                           for k, v in g.items()}, max_norm)
        for dt in (torch.float32, torch.bfloat16):
            tg, tn = popt.clip_by_global_norm(
                {k: torch.as_tensor(v).to(dt) for k, v in g.items()},
                max_norm)
            if dt == torch.float32:
                np.testing.assert_allclose(float(tn), float(rn), **SHARED)
                for k in g:
                    np.testing.assert_allclose(tg[k].numpy(),
                                               np.asarray(rg[k]), **SHARED)
            assert all(v.dtype == dt for v in tg.values())
        # a bf16 gradient is scaled in float32, then rounded once
        bg = {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()}
        rgb, _ = ropt.clip_by_global_norm(bg, max_norm)
        tgb, _ = popt.clip_by_global_norm(
            {k: torch.as_tensor(v).to(torch.bfloat16) for k, v in g.items()},
            max_norm)
        for k in g:
            np.testing.assert_array_equal(
                tgb[k].float().numpy(), np.asarray(rgb[k], np.float32))


def test_compress_decompress_equals_reference_and_is_unbiased():
    rng = np.random.default_rng(0)
    g = {"w": (rng.standard_normal((64, 64)) * 1e-3).astype(np.float32),
         "b": (rng.standard_normal(64) * 10).astype(np.float32)}
    rstate = {"ef": rgc.init_error_feedback({k: jnp.asarray(v)
                                             for k, v in g.items()})}
    tstate = {"ef": pgc.init_error_feedback({k: torch.as_tensor(v)
                                             for k, v in g.items()})}
    for _ in range(3):
        rout, rstate = rgc.compress_decompress(
            {k: jnp.asarray(v) for k, v in g.items()}, rstate)
        tout, tstate = pgc.compress_decompress(
            {k: torch.as_tensor(v) for k, v in g.items()}, tstate)
        for k in g:
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(rout[k]),
                                       **SHARED)
            np.testing.assert_allclose(tstate["ef"][k].numpy(),
                                       np.asarray(rstate["ef"][k]), rtol=1e-6,
                                       atol=1e-7 * np.abs(g[k]).max())
    q, s = pgc._quant_int8(torch.as_tensor(g["b"]))
    rq, rs = rgc._quant_int8(jnp.asarray(g["b"]))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(pgc._dequant(q, s).numpy(),
                               np.asarray(rgc._dequant(rq, rs)), **SHARED)
    # the reference's bar (tests/test_infra.py:232): error feedback makes
    # the accumulated compressed gradients the accumulated true ones
    g_true = {"w": torch.as_tensor(g["w"])}
    state = {"ef": pgc.init_error_feedback(g_true)}
    acc = torch.zeros(64, 64, dtype=torch.float64)
    for _ in range(50):
        out, state = pgc.compress_decompress(g_true, state)
        acc += out["w"].double()
    np.testing.assert_allclose(acc.numpy() / 50, g["w"], rtol=0.02,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------


def _ref_state_numpy(state):
    return {k: ({n: np.asarray(a) for n, a in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in state.items()}


def test_train_step_equals_reference():
    """Two float32 train steps of unionlm-smoke from the reference's
    ``init_train_state`` (carried over by ``train_state_from_numpy``) on
    the same batch, under the whole-step limit of the module docstring."""
    rc, pc = _cfgs("unionlm-100m", "float32")
    rtc = rstep.TrainConfig(opt=ropt.OptConfig(lr=1e-3), total_steps=10,
                            warmup_steps=1)
    ptc = pstep.TrainConfig(opt=popt.OptConfig(lr=1e-3), total_steps=10,
                            warmup_steps=1)
    rs = rstep.init_train_state(rc, rtc, seed=0)
    ts = train_state_from_numpy(pc, ptc, _ref_state_numpy(rs), device="cpu")
    assert all(v.dtype == torch.float32 for v in ts["params"].values())
    batch = _batch(rc)
    rfn = jax.jit(rstep.make_train_step(rc, rtc))
    tfn = pstep.make_train_step(pc, ptc)
    bound = 0.0
    for i in range(2):
        rs, rm = rfn(rs, _jax(batch))
        ts, tm = tfn(ts, _torch(batch))
        assert int(ts["step"]) == int(rs["step"]) == i + 1
        assert ts["step"].dtype == torch.int32
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(rm[k]), **F32,
                                       err_msg=k)
        bound += 2 * float(rm["lr"])
        outside, n = 0, 0
        for k, w in rs["params"].items():
            got, want = ts["params"][k].numpy(), np.asarray(w)
            d = np.abs(got.astype(np.float64) - want)
            assert d.max() <= bound, (k, d.max(), bound)
            outside += int((d > STEP_ATOL + STEP_RTOL * np.abs(want)).sum())
            n += want.size
        assert outside <= (1 - STEP_SHARE) * n, (outside, n)
        for k, w in rs["opt"].items():
            _grad_close(ts["opt"][k].numpy(), np.asarray(w), k)


def test_train_state_from_numpy_keeps_slot_dtypes():
    rc, pc = _cfgs("gemma2-9b", "bfloat16")
    for kind, m_dtype, compress in (("adafactor", "float32", False),
                                    ("adamw", "bfloat16", True)):
        rtc = rstep.TrainConfig(opt=ropt.OptConfig(kind=kind,
                                                   m_dtype=m_dtype),
                                compress_grads=compress)
        ptc = pstep.TrainConfig(opt=popt.OptConfig(kind=kind,
                                                   m_dtype=m_dtype),
                                compress_grads=compress)
        rs = rstep.init_train_state(rc, rtc, seed=1)
        ts = train_state_from_numpy(pc, ptc, _ref_state_numpy(rs), "cpu")
        own = pstep.init_train_state(pc, ptc, seed=1, device="cpu")
        assert set(ts) == set(own) == set(rs)
        for part in ("params", "opt") + (("ef",) if compress else ()):
            assert set(ts[part]) == set(own[part]) == set(rs[part])
            for k, v in ts[part].items():
                assert v.dtype == own[part][k].dtype, (part, k)
                assert v.shape == own[part][k].shape == rs[part][k].shape
                np.testing.assert_array_equal(
                    v.float().numpy(), np.asarray(rs[part][k], np.float32))


def test_train_step_with_grad_compression():
    """The reference's ``test_infra.py:274`` on the port: the error-feedback
    state threads through two steps."""
    cfg = pconfigs.get_smoke_config("minitron-8b")
    tc = pstep.TrainConfig(opt=popt.OptConfig(lr=1e-3), total_steps=10,
                           warmup_steps=1, compress_grads=True)
    state = pstep.init_train_state(cfg, tc, seed=0, device="cpu")
    assert "ef" in state
    step = pstep.make_train_step(cfg, tc)
    batch = _torch(_batch(cfg, S=64, seed=3))
    s1, _ = step(state, batch)
    s2, m2 = step(s1, batch)
    assert np.isfinite(float(m2["loss"]))
    assert sum(float(v.abs().sum()) for v in s2["ef"].values()) > 0


def test_microbatch_equivalence():
    """The reference's ``test_infra.py:299`` on the port: n_microbatches=2
    (float32 accumulation) updates as one batch does, within its bf16 bar;
    in float32 the loss is the same."""
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(pconfigs.get_smoke_config("minitron-8b"),
                                  dtype=dtype)
        rng = np.random.default_rng(4)
        batch = {"tokens": torch.as_tensor(rng.integers(4, cfg.vocab, (4, 64)),
                                           dtype=torch.int32),
                 "targets": torch.as_tensor(rng.integers(4, cfg.vocab, (4, 64)),
                                            dtype=torch.int32)}
        outs, losses = [], []
        for n_micro in (1, 2):
            tc = pstep.TrainConfig(opt=popt.OptConfig(lr=1e-2),
                                   total_steps=10, warmup_steps=1,
                                   n_microbatches=n_micro)
            state = pstep.init_train_state(cfg, tc, seed=0, device="cpu")
            s1, m1 = pstep.make_train_step(cfg, tc)(state, batch)
            outs.append(s1["params"]["blocks.wq"].numpy())
            losses.append(float(m1["loss"]))
        d = np.abs(outs[0] - outs[1]).max()
        scale = np.abs(outs[0]).max()
        assert d <= 0.1 * scale, (dtype, d, scale)
        if dtype == "float32":
            np.testing.assert_allclose(losses[1], losses[0], **F32)


def test_forward_train_rejects_families_not_ported(tmp_path):
    """Every family trains, but the train CLI feeds tokens and targets
    only, as the reference's does (``repro/launch/train.py:86-95``): for
    encdec and vlm both CLIs fail at the first step with a ``KeyError``
    naming the missing frontend."""
    from repro.launch import train as rtrain
    from repro_torch.launch import train as ptrain
    argv = ["--smoke", "--steps", "1", "--scale", "0.01", "--batch", "2",
            "--seq", "32"]
    for arch in ("whisper-medium", "paligemma-3b"):
        with pytest.raises(KeyError, match="frontend"):
            rtrain.main(argv + ["--arch", arch, "--checkpoint-dir",
                                str(tmp_path / "r" / arch)])
        with pytest.raises(KeyError, match="frontend"):
            ptrain.main(argv + ["--arch", arch, "--device", "cpu",
                                "--checkpoint-dir",
                                str(tmp_path / "p" / arch)])
