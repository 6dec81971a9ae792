"""The port's training of the moe, mamba2, zamba2, encdec and vlm families
against the JAX package: ``forward_train``'s loss, metrics and every
gradient on the smoke configs of phi3.5-moe, arctic, mamba2, zamba2,
whisper and paligemma, the family rules (vlm's target padding, moe's aux
term) and a missing frontend.  Whole train steps, the SSD scan's and
``moe_ffn``'s backward, the train state's dtypes and the train CLI are in
``test_torch_train_families_step.py``.

Both packages get the same inputs: numpy arrays from seeded generators,
the reference's ``init_params`` carried into the port by
``repro_torch.interop.params_from_numpy``, and for encdec and vlm the same
``frontend`` embeddings.  Gradients are taken with respect to
compute-dtype copies of the parameters (the train step's ``p16``).
Limits:

* float32 loss, ``aux_loss`` and ``tokens``: rtol 1e-4, atol 1e-4;
* float32 gradients: ``test_torch_train.py``'s rtol 1e-4 and atol 1e-5 ×
  max|g| of the tensor, except on the two SSM smoke models
  (``F32_SPREAD``).  Their float32 gradients are ill-conditioned: the
  reference's own jitted and eager (op-by-op) runs differ by 1.4e-4
  (mamba2) and 2.2e-4 (zamba2) of a tensor's largest gradient, and its
  jitted gradients lie 8.8e-5 and 5.7e-4 from a float64 run of the same
  arithmetic (per element, the SSD output's rows pass ``rms_norm``, which
  rescales rows whose entries cancel).  There every tensor's largest
  difference must stay within ``F32_SPREAD_FACTOR`` × the reference's own
  jitted-against-eager difference of the same model, over the whole model
  (measured: 2.4× and 1.8×), with correlation > ``F32_SPREAD_CORR``;
* bf16 (the configs' own dtype): the loss within rtol 1e-2, and each
  gradient tensor correlated > 0.999 with at most 5 % of its largest value
  as the largest difference (whisper and paligemma: measured ≥ 0.9998,
  ≤ 2.4 %).  Two exceptions, both found on these smoke models:

  - the SSM models (``BF16_CHAOTIC``) amplify one-ulp differences, as
    ``test_torch_lm_families.py`` finds for zamba2: at the smoke size
    (B 2 × S 64) the reference's own bf16 gradients are uncorrelated with
    its float32 ones (per tensor down to −0.35 for mamba2 and −0.72 for
    zamba2), so no bar there tells the port from zeros.  Their bf16
    gradients are held at a size where the reference's bf16 is stable
    (``BF16_STABLE``: mamba2's 2 layers and zamba2's first group of 3, at
    B 2 × S 16; the reference's bf16 gradients correlate ≥ 0.99 with its
    float32 ones there): per tensor, the port's bf16 gradients lie no
    farther from the reference's bf16 gradients than those lie from the
    reference's float32 gradients (RMS, within ``REF_BF16_FACTOR``;
    measured ≤ 0.70 and ≤ 1.20), and the test asserts that zeros and the
    negated gradients fail that bar (they lie ≥ 6.9× the reference's
    bf16 error away); the loss is held at the smoke size;
  - the moe models (``BF16_ROUTED``): a bf16 rounding difference upstream
    of a router (XLA and torch round the attention at other points) moves
    a near-tie token to another expert, which moves whole expert-weight
    gradients (one token of phi's 128 in layer 1; 32 % of a tensor's
    largest gradient, correlation down to 0.977).  The model-level bf16
    gradients are held to correlation > ``BF16_ROUTED_CORR``, and the bf16
    arithmetic of ``moe_ffn`` itself to the strict bar on shared inputs
    (``test_torch_train_families_step.py``'s
    ``test_moe_ffn_bf16_grads_equal_reference``: routing fixed by the
    inputs, measured ≤ 1.2 %, correlation ≥ 0.99995).

The reference's outputs are computed once per (arch, dtype) in this module
(``functools.lru_cache``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.models import transformer as rtrans

from repro_torch import configs as pconfigs
from repro_torch.interop import params_from_numpy
from repro_torch.models import transformer as ptrans

F32 = {"rtol": 1e-4, "atol": 1e-4}
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
BF16_CORR, BF16_REL, BF16_LOSS_RTOL = 0.999, 0.05, 1e-2
F32_SPREAD = ("mamba2-780m", "zamba2-7b")
F32_SPREAD_FACTOR, F32_SPREAD_CORR = 4.0, 0.99999
BF16_CHAOTIC = ("mamba2-780m", "zamba2-7b")
# (n_layers, S) where the reference's own bf16 gradients are stable
BF16_STABLE = {"mamba2-780m": (2, 16), "zamba2-7b": (3, 16)}
BF16_ROUTED = ("phi3.5-moe-42b-a6.6b", "arctic-480b")
REF_BF16_FACTOR, BF16_ROUTED_CORR = 1.25, 0.97
ARCHS = ["phi3.5-moe-42b-a6.6b", "arctic-480b", "mamba2-780m", "zamba2-7b",
         "whisper-medium", "paligemma-3b"]
B, S = 2, 64


def _cfgs(arch, dtype="float32", n_layers=None):
    rc = dataclasses.replace(rconfigs.get_smoke_config(arch), dtype=dtype)
    pc = dataclasses.replace(pconfigs.get_smoke_config(arch), dtype=dtype)
    if n_layers is not None:
        rc = dataclasses.replace(rc, n_layers=n_layers)
        pc = dataclasses.replace(pc, n_layers=n_layers)
    return rc, pc


@functools.lru_cache(maxsize=None)
def _params(arch, n_layers=None):
    rc, _ = _cfgs(arch, n_layers=n_layers)
    return {k: np.asarray(v) for k, v in rtrans.init_params(rc, seed=0).items()}


@functools.lru_cache(maxsize=None)
def _batch(arch, S=S):
    """Tokens in [4, vocab), targets in [0, vocab) (some PAD = 0) and, for
    encdec and vlm, float32 frontend embeddings."""
    rc, _ = _cfgs(arch)
    rng = np.random.default_rng(2)
    out = {"tokens": rng.integers(4, rc.vocab, (B, S)).astype(np.int32),
           "targets": rng.integers(0, rc.vocab, (B, S)).astype(np.int32)}
    if rc.frontend != "none":
        out["frontend"] = rng.standard_normal(
            (B, rc.n_frontend_tokens, rc.d_model)).astype(np.float32)
    return out


def _ref_value_and_grad(rc, jit=True):
    f = jax.value_and_grad(lambda p, b: rtrans.forward_train(p, rc, b),
                           has_aux=True)
    return jax.jit(f) if jit else f


@functools.lru_cache(maxsize=None)
def _reference(arch, dtype, jit=True, n_layers=None, S=S):
    """(loss, metrics, grads) of the reference, as numpy."""
    rc, _ = _cfgs(arch, dtype, n_layers)
    p16 = {k: jnp.asarray(v, rc.compute_dtype)
           for k, v in _params(arch, n_layers).items()}
    b = {k: jnp.asarray(v, rc.compute_dtype if k == "frontend" else None)
         for k, v in _batch(arch, S).items()}
    if jit:
        (loss, met), grads = _ref_value_and_grad(rc)(p16, b)
    else:
        with jax.disable_jit():
            (loss, met), grads = _ref_value_and_grad(rc, jit=False)(p16, b)
    return (float(loss), {k: float(v) for k, v in met.items()},
            {k: np.asarray(v, np.float64) for k, v in grads.items()})


def _port(arch, dtype, n_layers=None, S=S):
    """(loss, metrics, grads) of the port, differentiated with respect to
    compute-dtype copies of the float32 masters."""
    _, pc = _cfgs(arch, dtype, n_layers)
    masters = params_from_numpy(pc, _params(arch, n_layers), device="cpu",
                                dtype=torch.float32)
    t16 = {k: v.to(pc.compute_dtype).requires_grad_(True)
           for k, v in masters.items()}
    b = {k: torch.as_tensor(v) for k, v in _batch(arch, S).items()}
    if "frontend" in b:
        b["frontend"] = b["frontend"].to(pc.compute_dtype)
    loss, met = ptrans.forward_train(t16, pc, b)
    grads = torch.autograd.grad(loss, list(t16.values()),
                                materialize_grads=True)
    for g in grads:
        assert g.dtype == pc.compute_dtype
    return (float(loss.detach()), {k: float(v.detach())
                                   for k, v in met.items()},
            {k: g.float().numpy().astype(np.float64)
             for k, g in zip(t16, grads)})


def _worst_rel(a, b):
    """Largest |a - b| over the largest |b|, worst tensor of the model."""
    return max(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(), 1e-30)
               for k in b)


def _corr(a, b):
    if b.size < 2 or b.std() == 0:
        return 1.0
    return float(np.corrcoef(a.ravel(), b.ravel())[0, 1])


def _rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


# ---------------------------------------------------------------------------
# forward_train: loss, metrics and every gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_f32_equals_reference(arch):
    rloss, rmet, rgrads = _reference(arch, "float32")
    loss, met, grads = _port(arch, "float32")
    np.testing.assert_allclose(loss, rloss, **F32)
    for k in ("loss", "aux_loss", "tokens"):
        np.testing.assert_allclose(met[k], rmet[k], err_msg=k, **F32)
    assert set(grads) == set(rgrads)
    if arch not in F32_SPREAD:
        for k, g in grads.items():
            np.testing.assert_allclose(
                g, rgrads[k], rtol=GRAD_RTOL,
                atol=GRAD_ATOL * np.abs(rgrads[k]).max(), err_msg=k)
        return
    spread = _worst_rel(_reference(arch, "float32", jit=False)[2], rgrads)
    assert 0 < spread < 1e-3, spread
    for k, g in grads.items():
        rel = np.abs(g - rgrads[k]).max() / np.abs(rgrads[k]).max()
        assert rel <= F32_SPREAD_FACTOR * spread, (k, rel, spread)
        assert _corr(g, rgrads[k]) > F32_SPREAD_CORR, k


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_bf16_equals_reference(arch):
    rloss, rmet, rgrads = _reference(arch, "bfloat16")
    loss, met, grads = _port(arch, "bfloat16")
    np.testing.assert_allclose(loss, rloss, rtol=BF16_LOSS_RTOL)
    np.testing.assert_allclose(met["aux_loss"], rmet["aux_loss"],
                               rtol=BF16_LOSS_RTOL)
    assert met["tokens"] == rmet["tokens"]
    if arch in BF16_CHAOTIC:
        _check_bf16_where_stable(arch)
        return
    for k, g in grads.items():
        want = rgrads[k]
        if arch in BF16_ROUTED:
            assert _corr(g, want) > BF16_ROUTED_CORR, (k, _corr(g, want))
        else:
            rel = np.abs(g - want).max() / max(np.abs(want).max(), 1e-30)
            assert rel <= BF16_REL and _corr(g, want) > BF16_CORR, (k, rel)


def _check_bf16_where_stable(arch):
    """The port's bf16 gradients at ``BF16_STABLE[arch]`` no farther from
    the reference's than those are from the reference's float32 ones, a
    bar that zeros and the negated gradients fail."""
    nl, s = BF16_STABLE[arch]
    want = _reference(arch, "bfloat16", n_layers=nl, S=s)[2]
    f32 = _reference(arch, "float32", n_layers=nl, S=s)[2]
    got = _port(arch, "bfloat16", n_layers=nl, S=s)[2]
    held = 0
    for k, w in want.items():
        if not f32[k].any():            # a layer kind the cut model lacks
            assert not w.any() and not got[k].any(), k
            continue
        bar = REF_BF16_FACTOR * _rms(w, f32[k])
        assert _rms(0 * w, w) > bar and _rms(-w, w) > bar, k
        assert _rms(got[k], w) <= bar, (k, _rms(got[k], w) / bar)
        held += 1
    assert held >= 10, held


def test_family_rules_vlm_padding_and_moe_aux():
    """vlm: the patch prefix takes PAD targets, so ``tokens`` counts the
    B·S text targets that are not PAD; moe: the loss is ``metrics["loss"]``
    + 0.01 · aux, in both packages."""
    for arch in ("paligemma-3b", "phi3.5-moe-42b-a6.6b", "arctic-480b"):
        rloss, rmet, _ = _reference(arch, "float32")
        _, pc = _cfgs(arch)
        params = params_from_numpy(pc, _params(arch), device="cpu",
                                   dtype=torch.float32)
        b = {k: torch.as_tensor(v) for k, v in _batch(arch).items()}
        with torch.no_grad():
            loss, met = ptrans.forward_train(params, pc, b)
        text = float((_batch(arch)["targets"] != ptrans.PAD_ID).sum())
        assert float(met["tokens"]) == rmet["tokens"] == text
        if arch == "paligemma-3b":
            assert pc.n_frontend_tokens > 0
            assert float(loss) == float(met["loss"])
            assert float(met["aux_loss"]) == 0.0
        else:
            assert float(met["aux_loss"]) > 0
            assert float(loss) == float(met["loss"] + 0.01 * met["aux_loss"])
            np.testing.assert_allclose(rloss, rmet["loss"]
                                       + 0.01 * rmet["aux_loss"], rtol=1e-6)


def test_forward_train_names_a_missing_frontend():
    for arch in ("whisper-medium", "paligemma-3b"):
        _, pc = _cfgs(arch)
        toks = torch.ones((1, 4), dtype=torch.int32)
        with pytest.raises(KeyError, match="frontend"):
            ptrans.forward_train({}, pc, {"tokens": toks, "targets": toks})
