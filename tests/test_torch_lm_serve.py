"""The port's ``--mode lm`` serving loop against the reference CLI's.

Given the same parameters (the reference's ``init_params`` as numpy,
carried over by ``params_from_numpy``) and a float32 smoke config, the
port's ``serve_lm`` and the reference's ``main(["--mode", "lm", "--smoke",
…])`` serve the same requests with the same greedy tokens, and print the
same request lines.  Each package's ``get_smoke_config``/``init_params``
is replaced by monkeypatch in the test; neither package changes.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.models.transformer as rtrans
from repro.launch import serve as rserve_cli

import repro_torch.configs as pconfigs
import repro_torch.models.transformer as ptrans
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import attention as pattention
from repro_torch.launch import serve as pserve_cli


def _req_lines(text):
    return [ln for ln in text.splitlines() if ln.startswith("  req ")]


@pytest.mark.parametrize("arch,argv", [
    ("gemma2-9b", ["--slots", "4", "--requests", "6", "--max-new", "6",
                   "--max-len", "40"]),
    ("granite-20b", ["--slots", "2", "--requests", "3", "--max-new", "5",
                     "--max-len", "8"]),
    ("zamba2-7b", ["--slots", "3", "--requests", "4", "--max-new", "5",
                   "--max-len", "24"]),
    ("whisper-medium", ["--slots", "2", "--requests", "3", "--max-new", "4",
                        "--max-len", "16"])])
def test_serve_lm_equals_reference_cli(monkeypatch, capsys, arch, argv):
    rcfg = dataclasses.replace(rconfigs.get_smoke_config(arch),
                               dtype="float32")
    pcfg = dataclasses.replace(pconfigs.get_smoke_config(arch),
                               dtype="float32")
    rparams = rtrans.init_params(rcfg, seed=0)
    nparams = {k: np.asarray(v) for k, v in rparams.items()}
    monkeypatch.setattr(rconfigs, "get_smoke_config", lambda a: rcfg)
    monkeypatch.setattr(rtrans, "init_params", lambda cfg, seed=0: rparams)
    rserve_cli.main(["--mode", "lm", "--smoke", "--arch", arch] + argv)
    want = _req_lines(capsys.readouterr().out)

    kw = dict(zip((a[2:].replace("-", "_") for a in argv[::2]),
                  (int(a) for a in argv[1::2])))
    out = pserve_cli.serve_lm(pcfg, params_from_numpy(pcfg, nparams, "cpu"),
                              device="cpu", **kw)
    got = _req_lines(capsys.readouterr().out)
    assert got == want and len(got) == min(4, kw["requests"])
    assert len(out["done"]) == kw["requests"] and out["steps"] > 0
    assert all(len(toks) <= kw["max_new"] for _, toks in out["done"])

    # the CLI, with the port's own config and init patched the same way
    monkeypatch.setattr(pconfigs, "get_smoke_config", lambda a: pcfg)
    monkeypatch.setattr(ptrans, "init_params", lambda cfg, seed=0,
                        device=None: params_from_numpy(cfg, nparams, device))
    res = pserve_cli.main(["--smoke", "--arch", arch, "--device", "cpu"]
                          + argv)
    assert _req_lines(capsys.readouterr().out) == want
    assert res["done"] == out["done"]


def test_lm_is_the_default_mode_and_counts_b4_calls(monkeypatch, capsys):
    """``--mode`` defaults to ``lm``, as the reference's CLI; every decode
    step calls the B4 wrapper once per attention layer."""
    calls = [0]
    real = pattention.decode_attention

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)
    monkeypatch.setattr(pattention, "decode_attention", counted)
    res = pserve_cli.main(["--smoke", "--arch", "minitron-8b", "--device",
                           "cpu", "--requests", "2", "--max-new", "3",
                           "--slots", "2"])
    text = capsys.readouterr().out
    assert text.startswith("served 2 requests")
    cfg = pconfigs.get_smoke_config("minitron-8b")
    assert calls[0] == res["steps"] * cfg.n_layers
    assert res["tokens_per_s"] > 0 and res["steps_per_s"] > 0


def test_serve_lm_rejects_families_not_ported():
    """Every family of the configs serves; a family that no config has
    (and the port does not know) raises before any step."""
    cfg = dataclasses.replace(pconfigs.get_smoke_config("mamba2-780m"),
                              family="rwkv")
    with pytest.raises(ValueError, match="rwkv"):
        pserve_cli.serve_lm(cfg, {"embed": torch.zeros((cfg.vocab,
                                                        cfg.d_model))},
                            requests=1, device="cpu")
