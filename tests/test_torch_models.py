"""The port's LM side against the JAX package: configs, layers, the forward
pass, prefill and decode (``dense`` and ``gemma2``; the other families are
in ``test_torch_lm_families.py``).

Both packages get the same parameters: the reference's
``init_params(cfg, seed=0)`` as numpy, carried into the port by
``repro_torch.interop.params_from_numpy``.  Limits, on the smoke configs:

* float32 (``dataclasses.replace(cfg, dtype="float32")``): rtol 1e-4 and
  atol 1e-4 on hidden states, logits and caches (the two differ only in
  the order of float32 sums; measured ~1e-6 relative);
* bf16 (the configs' own dtype): correlation > 0.999 and the largest
  difference at most 5 % of the largest reference value (bf16 rounds at
  other points in XLA and in torch; measured 0.8-1.4 %);
* the port's decode against the port's prefill: the reference's own bar
  (``tests/test_models.py:86-89``), correlation > 0.99 and top-1 agreement
  >= 0.5.

On the CPU ``models.layers.decode_attention`` runs the B4 wrapper's plain
version; the card's kernel is held against it by
``test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.kernels.attention import decode_attention_pallas
from repro.models import layers as rlayers
from repro.models import serve as rserve
from repro.models import transformer as rtrans

from repro_torch import configs as pconfigs
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import attention as pattention
from repro_torch.kernels.cases import attention_inputs, attention_tol
from repro_torch.models import layers as players
from repro_torch.models import serve as pserve
from repro_torch.models import transformer as ptrans

F32 = {"rtol": 1e-4, "atol": 1e-4}
BF16_CORR, BF16_REL = 0.999, 0.05
LM_ARCHS = ["unionlm-100m", "minitron-8b", "granite-20b",
            "mistral-large-123b", "gemma2-9b"]
ALL_ARCHS = rconfigs.ASSIGNED_ARCHS + ["unionlm-100m"]


def _close_bf16(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert corr > BF16_CORR and rel <= BF16_REL, (what, corr, rel)


@functools.lru_cache(maxsize=None)
def _models(arch, dtype):
    """(reference cfg, port cfg, reference params, port params)."""
    rc = dataclasses.replace(rconfigs.get_smoke_config(arch), dtype=dtype)
    pc = dataclasses.replace(pconfigs.get_smoke_config(arch), dtype=dtype)
    rp = rtrans.init_params(rc, seed=0)
    tp = params_from_numpy(pc, {k: np.asarray(v) for k, v in rp.items()},
                           device="cpu")
    return rc, pc, rp, tp


def _tokens(cfg, B=2, T=9, seed=2):
    return np.random.default_rng(seed).integers(4, cfg.vocab, (B, T)
                                                 ).astype(np.int32)


# ---------------------------------------------------------------------------
# (f) configs, shapes and entries
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_and_entries_equal_reference(arch):
    for getter in ("get_config", "get_smoke_config"):
        rc = getattr(rconfigs, getter)(arch)
        pc = getattr(pconfigs, getter)(arch)
        assert dataclasses.asdict(rc) == dataclasses.asdict(pc)
        assert (rc.sub_quadratic, rc.n_zamba_groups, rc.n_zamba_tail) == (
            pc.sub_quadratic, pc.n_zamba_groups, pc.n_zamba_tail)
        assert dataclasses.asdict(rc.ssm_dims) == dataclasses.asdict(
            pc.ssm_dims)
        assert dataclasses.asdict(rc.moe_dims) == dataclasses.asdict(
            pc.moe_dims)
        assert pc.compute_dtype == {"bfloat16": torch.bfloat16,
                                    "float32": torch.float32}[rc.dtype]
        assert rtrans.param_entries(rc) == ptrans.param_entries(pc)
        assert rtrans.logical_axes(rc) == ptrans.logical_axes(pc)
        for batch, max_len in ((2, 48), (8, 8192)):
            assert (rserve.cache_entries(rc, batch, max_len)
                    == pserve.cache_entries(pc, batch, max_len))
            assert (rserve.cache_logical_axes(rc, batch, max_len)
                    == pserve.cache_logical_axes(pc, batch, max_len))
    for shape in rconfigs.SHAPES:
        assert (rconfigs.cell_runnable(arch, shape)
                == pconfigs.cell_runnable(arch, shape))


def test_registry_equals_reference():
    assert rconfigs.ASSIGNED_ARCHS == pconfigs.ASSIGNED_ARCHS
    assert {k: dataclasses.asdict(v) for k, v in rconfigs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in pconfigs.SHAPES.items()}
    assert rconfigs.all_cells() == pconfigs.all_cells()


@pytest.mark.parametrize("arch", ["gemma2-9b", "zamba2-7b", "minitron-8b",
                                  "phi3.5-moe-42b-a6.6b", "mamba2-780m",
                                  "whisper-medium", "paligemma-3b"])
def test_init_params_law(arch):
    """The reference's law on the port's generator: zeros for norms and
    gates, weights of std 1/sqrt(fan_in) stored in the compute dtype (the
    SSM's ``conv_w`` in float32, as the reference casts it at each use),
    the same seed the same values; one config of every family."""
    cfg = pconfigs.get_smoke_config(arch)
    a = ptrans.init_params(cfg, seed=3, device="cpu")
    b = ptrans.init_params(cfg, seed=3, device="cpu")
    assert set(a) == set(ptrans.param_entries(cfg))
    for k, (shp, _) in ptrans.param_entries(cfg).items():
        assert tuple(a[k].shape) == shp and torch.equal(a[k], b[k])
        law = ptrans.init_law(k, shp)
        if law == "zeros":
            assert a[k].dtype == torch.float32 and not a[k].any()
        elif law == "log_uniform":
            assert bool(((a[k] >= 0) & (a[k] <= np.log(16.0))).all())
        else:
            assert a[k].dtype == ptrans.param_dtype(cfg, k, shp) == (
                torch.float32 if k.endswith("conv_w") else cfg.compute_dtype)
            fan_in = shp[-2] if len(shp) >= 2 else shp[-1]
            std = float(a[k].float().std()) * np.sqrt(fan_in)
            assert 0.8 < std < 1.2, (k, std)
    assert not torch.equal(a["embed"], ptrans.init_params(
        cfg, seed=4, device="cpu")["embed"])


def test_other_families_raise_not_implemented():
    """The five other families train as they serve: ``forward_train``
    runs for each (a finite loss, every parameter reached; their values
    against the reference are in ``test_torch_train_families.py``), and
    every family's caches have the reference's shapes and dtypes."""
    for arch in ("phi3.5-moe-42b-a6.6b", "mamba2-780m", "zamba2-7b",
                 "whisper-medium", "paligemma-3b"):
        cfg = pconfigs.get_smoke_config(arch)
        params = ptrans.init_params(cfg, seed=0, device="cpu")
        toks = torch.ones((1, 16), dtype=torch.int32)
        batch = {"tokens": toks, "targets": toks}
        if cfg.frontend != "none":
            batch["frontend"] = torch.zeros((1, cfg.n_frontend_tokens,
                                             cfg.d_model))
        loss, met = ptrans.forward_train(params, cfg, batch)
        assert torch.isfinite(loss) and float(met["tokens"]) == 16
        # every family's caches have the reference's shapes and dtypes
        cache = pserve.init_cache(cfg, 2, 16, device="cpu")
        want = rserve.init_cache(rconfigs.get_smoke_config(arch), 2, 16)
        assert {k: tuple(v.shape) for k, v in cache.items()} == {
            k: tuple(v.shape) for k, v in want.items()}
        assert {k: str(v.dtype).split(".")[-1] for k, v in cache.items()} \
            == {k: str(v.dtype) for k, v in want.items()}


# ---------------------------------------------------------------------------
# (d) layers
# ---------------------------------------------------------------------------


def test_norm_rope_softcap_mlp_equal_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 100, (2, 5))
    w = [rng.standard_normal(s).astype(np.float32) * 0.3
         for s in ((16, 24), (16, 24), (24, 16))]
    T = torch.as_tensor
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        tol = F32 if dt == torch.float32 else attention_tol(dt)
        xt, xj = T(x).to(dt), jnp.asarray(x, jdt)
        pairs = [
            (players.rms_norm(xt, T(scale)), rlayers.rms_norm(xj, scale)),
            (players.rope(xt, T(pos), 10000.0), rlayers.rope(xj, pos)),
            (players.softcap(xt.float() * 40, 30.0),
             rlayers.softcap(jnp.asarray(x * 40), 30.0)),
            (players.swiglu(xt, *(T(a).to(dt) for a in w)),
             rlayers.swiglu(xj, *(jnp.asarray(a, jdt) for a in w))),
            (players.gelu_mlp(xt, T(w[0]).to(dt), T(w[2]).to(dt)),
             rlayers.gelu_mlp(xj, jnp.asarray(w[0], jdt),
                              jnp.asarray(w[2], jdt))),
        ]
        for i, (got, want) in enumerate(pairs):
            want = np.asarray(jnp.asarray(want, jnp.float32))
            if dt == torch.bfloat16 and i >= 3:   # products in bf16
                _close_bf16(got.float().numpy(), want, i)
            else:
                np.testing.assert_allclose(got.float().numpy(), want,
                                           **tol, err_msg=str(i))
    assert players.fit_chunk(1500, 256) == rlayers.fit_chunk(1500, 256) == 250


@pytest.mark.parametrize("causal,window,cap,prefix", [
    (True, 0, 0.0, 0), (True, 24, 30.0, 0), (True, 0, 0.0, 16),
    (True, 20, 0.0, 8), (False, 0, 0.0, 0)])
def test_flash_attention_equals_reference(causal, window, cap, prefix):
    rng = np.random.default_rng(3)
    B, S, H, KV, D = 2, 64, 6, 2, 16
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))
    want = rlayers.flash_attention_cv(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal, window, cap,
                                      16, 32, prefix)
    got = players.flash_attention_cv(torch.as_tensor(q), torch.as_tensor(k),
                                     torch.as_tensor(v), causal, window, cap,
                                     16, 32, prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    if prefix == 0:
        want2 = rlayers.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal,
                                        window=window, cap=cap, q_chunk=32,
                                        kv_chunk=16)
        got2 = players.flash_attention(
            torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
            causal=causal, window=window, cap=cap, q_chunk=32, kv_chunk=16)
        np.testing.assert_allclose(got2.numpy(), np.asarray(want2), **F32)


# ---------------------------------------------------------------------------
# (e) decode attention at the new shapes
# ---------------------------------------------------------------------------

# (B, H, KVH, D, S, window, cap): D 16 and 112, G 1, 7, 12 and 48
DECODE_SHAPES = [
    (2, 4, 4, 16, 40, 0, 0.0), (2, 6, 2, 16, 70, 16, 50.0),
    (1, 8, 2, 112, 50, 0, 30.0), (2, 14, 2, 128, 60, 20, 0.0),
    (2, 24, 2, 64, 40, 8, 50.0), (1, 48, 1, 16, 33, 0, 0.0),
    (2, 96, 2, 128, 36, 12, 30.0), (2, 4, 1, 112, 20, 0, 0.0)]


@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_attention_equals_reference(shape):
    B, H, KVH, D, S, win, cap = shape
    q, k, v, lens = attention_inputs(B, H, KVH, D, S, H * 100 + D)
    lens[0] = min(lens[0], 3)               # shorter than the window
    got = players.decode_attention(*(torch.as_tensor(x) for x in (q, k, v)),
                                   torch.as_tensor(lens), window=win, cap=cap)
    want = rlayers.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(lens),
                                    window=win, cap=cap)
    tol = attention_tol(torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    # the Pallas kernel in interpret mode takes every one of these shapes
    # (it pads S to its 128-row KV block)
    pal = decode_attention_pallas(q, k, v, lens, softcap=cap, window=win,
                                  interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), **tol)


# ---------------------------------------------------------------------------
# (a) forward_hidden and prefill, (b) decode, (c) decode against prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_prefill_equal_reference(arch, dtype):
    rc, pc, rp, tp = _models(arch, dtype)
    toks = _tokens(rc)
    hid, _ = rtrans.forward_hidden(rp, rc, {"tokens": jnp.asarray(toks)})
    logits = rserve.prefill_step(rp, rc, {"tokens": jnp.asarray(toks)})
    phid, aux = ptrans.forward_hidden(tp, pc, {"tokens": torch.as_tensor(toks)})
    plog = pserve.prefill_step(tp, pc, {"tokens": torch.as_tensor(toks)})
    assert phid.dtype == pc.compute_dtype and plog.dtype == torch.float32
    assert float(aux) == 0.0
    pairs = ((phid.float().numpy(), np.asarray(hid, np.float32)),
             (plog.numpy(), np.asarray(logits)))
    for what, (got, want) in zip(("hidden", "logits"), pairs):
        if dtype == "float32":
            np.testing.assert_allclose(got, want, **F32, err_msg=what)
        else:
            _close_bf16(got, want, what)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_steps_equal_reference(arch):
    """9 steps from an empty cache of 48 slots, float32, every step's
    logits and every cache compared.  Row 1 starts at length 30, so its
    positions run 30-38: past the smoke window 32, gemma2's local ring
    wraps there (writes at lengths % 32, window 0 over 32 slots)."""
    rc, pc, rp, tp = _models(arch, "float32")
    B, T, max_len = 2, 9, 48
    toks = _tokens(rc, B, T, seed=5)
    start = np.array([0, 30])
    cache = rserve.init_cache(rc, B, max_len)
    tcache = pserve.init_cache(pc, B, max_len, device="cpu")
    dstep = jax.jit(lambda c, t, l: rserve.decode_step(rp, rc, c, t, l))
    for t in range(T):
        lens = (start + t).astype(np.int32)
        cache, want = dstep(cache, jnp.asarray(toks[:, t:t + 1]),
                            jnp.asarray(lens))
        tcache, got = pserve.decode_step(tp, pc, tcache,
                                         torch.as_tensor(toks[:, t:t + 1]),
                                         torch.as_tensor(lens))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32,
                                   err_msg=f"logits step {t}")
        assert set(tcache) == set(cache)
        for k in cache:
            np.testing.assert_allclose(tcache[k].numpy(), np.asarray(cache[k]),
                                       **F32, err_msg=f"cache {k} step {t}")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_matches_port_prefill(arch):
    """The reference's own check, on the port alone, in the config's bf16."""
    _, pc, _, tp = _models(arch, "bfloat16")
    B, T = 2, 9
    toks = torch.as_tensor(_tokens(pc, B, T))
    cache = pserve.init_cache(pc, B, 32, device="cpu")
    for t in range(T):
        cache, logits = pserve.decode_step(tp, pc, cache, toks[:, t:t + 1],
                                           torch.full((B,), t))
    full = pserve.prefill_step(tp, pc, {"tokens": toks})
    got, want = logits.numpy(), full.numpy()
    corr = np.corrcoef(got.ravel(), want.ravel())[0, 1]
    assert corr > 0.99, corr
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.5


# ---------------------------------------------------------------------------
# (h) decode reaches the B4 wrapper
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["minitron-8b", "gemma2-9b"])
def test_decode_step_calls_the_b4_wrapper(monkeypatch, arch):
    """Every attention layer of a step calls
    ``repro_torch.kernels.attention.decode_attention`` (the wrapper that
    launches B4 on the card), never the plain version itself: with the
    wrapper stubbed out, the plain version is not called at all."""
    _, pc, _, tp = _models(arch, "bfloat16")
    calls = {"wrapper": 0, "plain": 0}
    real_plain = pattention.decode_attention_plain

    def wrapper(q, k, v, lengths, **kw):
        calls["wrapper"] += 1
        assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
        return torch.zeros_like(q)

    def plain(*a, **kw):
        calls["plain"] += 1
        return real_plain(*a, **kw)

    monkeypatch.setattr(pattention, "decode_attention", wrapper)
    monkeypatch.setattr(pattention, "decode_attention_plain", plain)
    cache = pserve.init_cache(pc, 2, 16, device="cpu")
    for t in range(3):
        pserve.decode_step(tp, pc, cache, torch.ones((2, 1), dtype=torch.int32),
                           torch.full((2,), t))
    assert calls == {"wrapper": 3 * pc.n_layers, "plain": 0}


def test_params_from_numpy_dtypes():
    rc, pc, rp, tp = _models("gemma2-9b", "bfloat16")
    for k, v in tp.items():
        want = np.asarray(rp[k])
        if ptrans.init_law(k, want.shape) == "normal":
            assert v.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                v.float().numpy(),
                np.asarray(jnp.asarray(want).astype(jnp.bfloat16), np.float32))
        else:
            assert v.dtype == torch.float32
            np.testing.assert_array_equal(v.numpy(), want)
    f32 = params_from_numpy(pc, {k: np.asarray(v) for k, v in rp.items()},
                            device="cpu", dtype=torch.float32)
    assert all(v.dtype == torch.float32 for v in f32.values())
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(pc, {**{k: np.asarray(v) for k, v in rp.items()},
                               "embed": np.zeros((3, 3), np.float32)},
                          device="cpu")
