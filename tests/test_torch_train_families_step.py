"""Whole train steps of the moe, mamba2, zamba2, encdec and vlm families
against the JAX package, and the pieces under them: the SSD scan's and
``moe_ffn``'s backward, the μ-batch split of a ``frontend`` batch, the
train state's dtypes for every family, and the train CLI (``forward_train``
itself is held in ``test_torch_train_families.py``).

Both packages get the same inputs (numpy arrays from seeded generators;
the reference's ``init_train_state`` carried into the port by
``train_state_from_numpy``).  Limits:

* one whole float32 AdamW step (``test_torch_train.py``'s
  ``test_train_step_equals_reference``): loss, grad-norm and lr within
  rtol 1e-4 / atol 1e-4; every parameter within 2·lr of the reference's
  and at least 99.9 % of them within rtol 1e-4 and atol 1e-6; the
  optimizer slots as gradients (rtol 1e-4, atol 1e-5 × max), except on
  the two SSM smoke models, whose float32 gradients are ill-conditioned
  (``test_torch_train_families.py``): there the grad-norm within rtol
  ``F32_SPREAD_FACTOR`` × ``REF_F32_SPREAD``, each slot's largest
  difference within ``F32_SPREAD_FACTOR`` × the reference's own
  jitted-against-eager gradient difference measured there
  (``REF_F32_SPREAD``; twice that for the squared-gradient ``v``),
  correlation > 0.99999, and every parameter outside rtol 1e-4 one whose
  clipped reference gradient lies within that spread of 0 (Adam's first
  step turns its sign into ±lr) or within ``ADAM_NEAR_EPS`` × Adam's eps
  (the step ``lr·g/(|g| + eps)`` follows g's error there): zamba2, whose
  gradients are clipped by a factor of 107, has 223 such of 214,808;
* the SSD scan's and ``moe_ffn``'s gradients within 1e-4 / 1e-5 of the
  tensor's largest value (float32); ``moe_ffn`` in bf16 correlated >
  0.999 and within 5 % of the largest value; the SSD's forward at a
  chunk of 128 within 1e-4 / 1e-5 of the largest value.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import moe as rmoe
from repro.models import ssm as rssm
from repro.train import optimizer as ropt
from repro.train import train_step as rstep

from repro_torch import configs as pconfigs
from repro_torch.interop import train_state_from_numpy
from repro_torch.models import moe as pmoe
from repro_torch.models import ssm as pssm
from repro_torch.train import optimizer as popt
from repro_torch.train import train_step as pstep

F32 = {"rtol": 1e-4, "atol": 1e-4}
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
BF16_CORR, BF16_REL = 0.999, 0.05
STEP_RTOL, STEP_ATOL, STEP_SHARE = 1e-4, 1e-6, 0.999
# the reference's own float32 spread (jitted against eager gradients,
# worst tensor, relative to its largest value), as
# test_torch_train_families.py measures it
REF_F32_SPREAD = {"mamba2-780m": 1.44e-4, "zamba2-7b": 2.20e-4}
F32_SPREAD_FACTOR, F32_SPREAD_CORR = 4.0, 0.99999
ADAM_NEAR_EPS = 100
ARCHS = ["phi3.5-moe-42b-a6.6b", "arctic-480b", "mamba2-780m", "zamba2-7b",
         "whisper-medium", "paligemma-3b"]
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LR = 1e-3


def _cfgs(arch, dtype="float32"):
    rc = dataclasses.replace(rconfigs.get_smoke_config(arch), dtype=dtype)
    pc = dataclasses.replace(pconfigs.get_smoke_config(arch), dtype=dtype)
    return rc, pc


def _batch(cfg, B=2, S=64, seed=2):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(4, cfg.vocab, (B, S)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.frontend != "none":
        out["frontend"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _numpy_state(state):
    return {k: ({n: np.asarray(a) for n, a in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in state.items()}


def _corr(a, b):
    if b.size < 2 or b.std() == 0:
        return 1.0
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def _steps(arch, n_micro=1, B=2):
    """One float32 train step of both packages from the reference's
    initial state on one batch: (reference state, metrics), (port state,
    metrics)."""
    rc, pc = _cfgs(arch)
    kw = dict(total_steps=10, warmup_steps=1, n_microbatches=n_micro)
    rtc = rstep.TrainConfig(opt=ropt.OptConfig(lr=LR), **kw)
    ptc = pstep.TrainConfig(opt=popt.OptConfig(lr=LR), **kw)
    rs = rstep.init_train_state(rc, rtc, seed=0)
    ts = train_state_from_numpy(pc, ptc, _numpy_state(rs), device="cpu")
    batch = _batch(rc, B=B)
    rs, rm = jax.jit(rstep.make_train_step(rc, rtc))(
        rs, {k: jnp.asarray(v) for k, v in batch.items()})
    ts, tm = pstep.make_train_step(pc, ptc)(
        ts, {k: torch.as_tensor(v) for k, v in batch.items()})
    return (rs, rm), (ts, tm)


def _check_step(arch, ref, port):
    (rs, rm), (ts, tm) = ref, port
    assert int(ts["step"]) == int(rs["step"]) == 1
    assert set(tm) == set(rm)
    for k in ("loss", "grad_norm", "lr"):
        if k == "grad_norm" and arch in REF_F32_SPREAD:
            np.testing.assert_allclose(
                float(tm[k]), float(rm[k]), err_msg=k,
                rtol=F32_SPREAD_FACTOR * REF_F32_SPREAD[arch])
            continue
        np.testing.assert_allclose(float(tm[k]), float(rm[k]), err_msg=k,
                                   **F32)
    bound = 2 * float(rm["lr"])
    outside, n = 0, 0
    for k, w in rs["params"].items():
        want = np.asarray(w, np.float64)
        d = np.abs(ts["params"][k].numpy().astype(np.float64) - want)
        assert d.max() <= bound, (k, d.max(), bound)
        off = d > STEP_ATOL + STEP_RTOL * np.abs(want)
        if arch in REF_F32_SPREAD:
            # Adam's first step moves an element by lr·g/(|g| + eps), g
            # the clipped gradient (= m / (1 - b1)): ±lr, unless g lies
            # within the float32 spread of 0 (its sign may differ) or
            # within ADAM_NEAR_EPS·eps (the step follows g's error)
            m = np.abs(np.asarray(rs["opt"][f"m.{k}"], np.float64))
            g = m / (1 - ropt.OptConfig().b1)
            near0 = ((m <= F32_SPREAD_FACTOR * REF_F32_SPREAD[arch] * m.max())
                     | (g <= ADAM_NEAR_EPS * ropt.OptConfig().eps))
            assert not (off & ~near0).any(), k
        outside += int(off.sum())
        n += want.size
    if arch not in REF_F32_SPREAD:
        assert outside <= (1 - STEP_SHARE) * n, (outside, n)
    for k, w in rs["opt"].items():
        got = ts["opt"][k].numpy().astype(np.float64)
        want = np.asarray(w, np.float64)
        if arch in REF_F32_SPREAD:
            lim = F32_SPREAD_FACTOR * REF_F32_SPREAD[arch] * (
                2 if k.startswith("v.") else 1)
            rel = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
            assert rel <= lim and _corr(got, want) > F32_SPREAD_CORR, (k,
                                                                       rel)
        else:
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL * np.abs(want).max(),
                                       err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_equals_reference(arch):
    ref, port = _steps(arch)
    _check_step(arch, ref, port)


def test_microbatch_splits_a_frontend_batch():
    """``n_microbatches=2`` on whisper's smoke config: the frames split
    with the tokens, and the step equals the reference's μ-batch step,
    whose metrics are the loss only (plus grad-norm and lr)."""
    ref, port = _steps("whisper-medium", n_micro=2, B=4)
    assert set(port[1]) == set(ref[1]) == {"loss", "grad_norm", "lr"}
    _check_step("whisper-medium", ref, port)


# ---------------------------------------------------------------------------
# the SSD scan's and moe_ffn's backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_grads_equal_reference_and_stay_finite(chunk):
    """Gradients of ``ssd_chunked`` against the reference's, at a long
    chunk whose masked (upper-triangle) exponents would overflow unmasked:
    decays of up to e^-8 a step sum past -89 over a chunk."""
    rng = np.random.default_rng(7)
    Bz, Sz, H, P, N = 2, 128, 4, 8, 8
    u = rng.standard_normal((Bz, Sz, H, P)).astype(np.float32)
    la = (-np.abs(rng.standard_normal((Bz, Sz, H))) * 8).astype(np.float32)
    Bm = rng.standard_normal((Bz, Sz, N)).astype(np.float32)
    Cm = rng.standard_normal((Bz, Sz, N)).astype(np.float32)
    ct = rng.standard_normal((Bz, Sz, H, P)).astype(np.float32)
    cth = rng.standard_normal((Bz, H, N, P)).astype(np.float32)

    def f(*a):
        y, h = rssm.ssd_chunked(*a, chunk=chunk)
        return jnp.sum(y * ct) + jnp.sum(h * cth)
    want = jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (u, la, Bm, Cm)))
    t = [torch.tensor(a, requires_grad=True) for a in (u, la, Bm, Cm)]
    y, h = pssm.ssd_chunked(*t, chunk=chunk)
    ((y * torch.as_tensor(ct)).sum() + (h * torch.as_tensor(cth)).sum()
     ).backward()
    # an unmasked upper-triangle exponent would overflow float32
    assert -float(la.reshape(Bz, -1, chunk, H).sum(2).min()) > 89
    for name, a, w in zip(("u", "log_a", "B", "C"), t, want):
        g = a.grad.numpy()
        assert np.isfinite(g).all(), name
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(w).max(),
                                   err_msg=name)


def test_ssd_long_chunk_forward_equals_reference():
    """``ssd_chunked`` at mamba2-780m's chunk of 128 over S 1024: the
    output and the final state against the reference's within 1e-4 of the
    largest value.  The prefix sums of the decays (``torch.cumsum``) grow
    over a whole chunk, and the exponent subtracts two of them, so their
    summation order shows here first."""
    rng = np.random.default_rng(3)
    Bz, Sz, H, P, N = 2, 1024, 4, 8, 8
    u = rng.standard_normal((Bz, Sz, H, P)).astype(np.float32)
    la = (-np.abs(rng.standard_normal((Bz, Sz, H))) * 0.5).astype(np.float32)
    Bm = rng.standard_normal((Bz, Sz, N)).astype(np.float32)
    Cm = rng.standard_normal((Bz, Sz, N)).astype(np.float32)
    wy, wh = jax.jit(lambda *a: rssm.ssd_chunked(*a, chunk=128))(
        *map(jnp.asarray, (u, la, Bm, Cm)))
    y, h = pssm.ssd_chunked(*map(torch.as_tensor, (u, la, Bm, Cm)),
                            chunk=128)
    for name, got, want in (("y", y, wy), ("h", h, wh)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * np.abs(want).max(),
                                   err_msg=name)


def _moe_case(case):
    """(dims, params, x, capacity): the cases of
    ``test_torch_lm_families.py``'s ``moe_ffn`` test."""
    rng = np.random.default_rng(6)
    dims = rmoe.MoEDims(d_model=32, n_experts=4, top_k=2, d_ff=64)
    params = {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
              for k, s in rmoe.moe_param_shapes(dims).items()}
    x = rng.standard_normal((2, 16, 32)).astype(np.float32)
    cap = None
    if case == "capacity_ties":
        # equal gate scores at the capacity boundary, and zeros of assign
        # ranked by index among themselves
        x = x.reshape(32, 32)[[0, 1, 2] * 10 + [0, 1]].reshape(2, 16, 32)
    elif case == "dropless":
        cap = 32
    return dims, params, x, cap


def _moe_grads(dims, params, x, cap, ct, dtype):
    """Reference and port gradients of sum(out · ct) + 0.01 · aux with
    respect to the four weights and x."""
    jdt = getattr(jnp, dtype)

    def f(p, x):
        out, aux = rmoe.moe_ffn(p, x, dims, capacity=cap)
        return jnp.sum(out.astype(jnp.float32) * ct) + 0.01 * aux
    rg = jax.jit(jax.grad(f, argnums=(0, 1)))(
        {k: jnp.asarray(v, jdt) for k, v in params.items()},
        jnp.asarray(x, jdt))
    want = {**rg[0], "x": rg[1]}
    tp = {k: torch.tensor(v).to(TORCH_DTYPES[dtype]).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.tensor(x).to(TORCH_DTYPES[dtype]).requires_grad_(True)
    out, aux = pmoe.moe_ffn(tp, tx, pmoe.MoEDims(**dataclasses.asdict(dims)),
                            capacity=cap)
    ((out.float() * torch.as_tensor(ct)).sum() + 0.01 * aux).backward()
    got = {**{k: v.grad for k, v in tp.items()}, "x": tx.grad}
    return ({k: v.float().numpy().astype(np.float64) for k, v in got.items()},
            {k: np.asarray(v, np.float64) for k, v in want.items()})


@pytest.mark.parametrize("case", ["random", "capacity_ties", "dropless"])
def test_moe_ffn_grads_equal_reference(case):
    """The backward through the stable sort's gathers, the in-place
    ``assign[...] = topv`` and ``index_add_`` (float32, within 1e-5 of the
    tensor's largest gradient); on the tie case the tokens kept at the
    capacity boundary, so their gradients, are the reference's."""
    dims, params, x, cap = _moe_case(case)
    ct = np.random.default_rng(8).standard_normal(x.shape).astype(np.float32)
    got, want = _moe_grads(dims, params, x, cap, ct, "float32")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[k]).max(),
                                   err_msg=k)


def test_moe_ffn_bf16_grads_equal_reference():
    """``moe_ffn`` in bf16 on shared inputs (phi's smoke widths, its
    capacity factor): every gradient correlated > 0.999 and within 5 % of
    its largest value."""
    rng = np.random.default_rng(0)
    dims = rmoe.MoEDims(64, 4, 2, 128, 8.0)
    params = {k: (rng.standard_normal(s) / np.sqrt(s[-2])).astype(np.float32)
              for k, s in rmoe.moe_param_shapes(dims).items()}
    x = rng.standard_normal((2, 64, 64)).astype(np.float32)
    ct = rng.standard_normal((2, 64, 64)).astype(np.float32)
    got, want = _moe_grads(dims, params, x, None, ct, "bfloat16")
    for k in want:
        rel = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert rel <= BF16_REL and _corr(got[k], want[k]) > BF16_CORR, (k,
                                                                          rel)


# ---------------------------------------------------------------------------
# the train state's dtypes, every family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["mamba2-780m", "arctic-480b",
                                  "whisper-medium"])
def test_train_state_from_numpy_keeps_every_familys_dtypes(arch):
    """Float32 masters (``conv_w`` included), adafactor's factored slots
    and ``ef`` in float32, a bf16 ``m`` under ``m_dtype="bfloat16"``; the
    same names, shapes and values as the reference's state."""
    rc, pc = _cfgs(arch, "bfloat16")
    for kind, m_dtype, compress in (("adafactor", "float32", False),
                                    ("adamw", "bfloat16", True)):
        rtc = rstep.TrainConfig(opt=ropt.OptConfig(kind=kind, m_dtype=m_dtype),
                                compress_grads=compress)
        ptc = pstep.TrainConfig(opt=popt.OptConfig(kind=kind, m_dtype=m_dtype),
                                compress_grads=compress)
        rs = rstep.init_train_state(rc, rtc, seed=1)
        ts = train_state_from_numpy(pc, ptc, {
            k: ({n: np.asarray(a) for n, a in v.items()}
                if isinstance(v, dict) else np.asarray(v))
            for k, v in rs.items()}, "cpu")
        own = pstep.init_train_state(pc, ptc, seed=1, device="cpu")
        assert set(ts) == set(own) == set(rs)
        for part in ("params", "opt") + (("ef",) if compress else ()):
            assert set(ts[part]) == set(own[part]) == set(rs[part])
            for k, v in ts[part].items():
                assert v.dtype == own[part][k].dtype, (part, k)
                assert str(v.dtype).split(".")[1] == str(rs[part][k].dtype)
                np.testing.assert_array_equal(
                    v.float().numpy(), np.asarray(rs[part][k], np.float32))
        if pc.family in ("mamba2", "zamba2"):
            assert ts["params"]["blocks.conv_w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------


def test_train_cli_trains_an_ssm_family(tmp_path):
    """``--arch mamba2-780m --smoke`` trains from union samples on the CPU
    (the reference's CLI trains every family that needs no frontend)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-780m", "--smoke", "--device", "cpu", "--steps", "2",
         "--scale", "0.01", "--batch", "2", "--seq", "32",
         "--checkpoint-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "done: 2 steps" in proc.stdout
