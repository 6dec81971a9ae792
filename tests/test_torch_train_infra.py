"""The port's training infrastructure against the JAX package: token
encoding, the sample pipeline, checkpoints, the fault-tolerant supervisor
and the train CLI.

Limits: token batches, pipeline state and checkpoint leaves are compared
exactly (the same numpy arithmetic and the same bytes); the train CLI's
losses within rtol 1e-4 and atol 1e-4 (float32 smoke config on shared
weights and shared batches, the float32 limit of
``tests/test_torch_train.py``; the printed four decimals are compared as
numbers).  The CLI test replaces, by monkeypatch, each package's smoke
config with its float32 copy and the port's initial state with the
reference's parameters, and runs the port's sampler on its host engine
(``backend="numpy"``), which draws exactly the reference's default
engine's stream from the same seed; neither package changes.
"""

import dataclasses
import functools
import json
import os
import re
import time

import numpy as np
import pytest
import torch

import repro.configs as rconfigs
import repro.models.transformer as rtrans
from repro.checkpoint.checkpointer import Checkpointer as RCheckpointer
from repro.core.union_sampler import SampleSet as RSampleSet
from repro.data.encode import TokenEncoder as RTokenEncoder
from repro.data.pipeline import SyntheticPipeline as RSynthetic
from repro.data.pipeline import UnionSamplePipeline as RPipeline
from repro.launch import train as rtrain

import repro_torch.configs as pconfigs
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.union_sampler import SampleSet, SetUnionSampler
from repro_torch.data.encode import TokenEncoder
from repro_torch.data.pipeline import SyntheticPipeline, UnionSamplePipeline
from repro_torch.interop import params_from_numpy
from repro_torch.launch import train as ptrain
from repro_torch.launch.ft import FTConfig, TrainSupervisor
from repro_torch.train.optimizer import init_opt_state

F32 = {"rtol": 1e-4, "atol": 1e-4}
ATTRS = ["ck", "nk", "odate", "ok"]


def _rows(rng, n, attrs=ATTRS):
    """Columns of int64 values over a wide range (negative ones too)."""
    return {a: rng.integers(-2 ** 40, 2 ** 40, n) for a in attrs}


# ---------------------------------------------------------------------------
# token encoding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("vocab,batch,seq", [(1024, 4, 64), (512, 3, 37),
                                             (8192, 2, 6)])
def test_token_encoder_pack_equals_reference(vocab, batch, seq):
    rng = np.random.default_rng(vocab + seq)
    rows = _rows(rng, 400)
    mine, ref = TokenEncoder(ATTRS, vocab), RTokenEncoder(ATTRS, vocab)
    assert (mine.buckets, mine.tokens_per_tuple) == (ref.buckets,
                                                     ref.tokens_per_tuple)
    np.testing.assert_array_equal(mine.encode_rows(rows), ref.encode_rows(rows))
    got, want = mine.pack(rows, batch, seq), ref.pack(rows, batch, seq)
    assert got[2] == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert (got[0][:, 0] == 1).all() and (got[0] < vocab).all()
    with pytest.raises(ValueError, match="need"):
        mine.pack(_rows(rng, 1), 8, 64)
    # a sequence shorter than BOS + one tuple raises in both packages
    for enc in (mine, ref):
        with pytest.raises(ValueError):
            enc.pack(rows, batch, mine.tokens_per_tuple)
    with pytest.raises(ValueError, match="vocab"):
        TokenEncoder(ATTRS, 7)


# ---------------------------------------------------------------------------
# the sample pipeline
# ---------------------------------------------------------------------------


class _Stub:
    """A sampler drawing rows from a numpy generator (its ``rng``, as the
    union samplers'), returning each package's ``SampleSet``."""

    def __init__(self, cls, seed, delay=0.0, fail=False):
        self.cls, self.rng, self.delay, self.fail = cls, np.random.default_rng(
            seed), delay, fail

    def sample(self, n):
        if self.fail:
            raise RuntimeError("sampler failed")
        time.sleep(self.delay)
        rows = _rows(self.rng, n)
        return self.cls(list(ATTRS), rows, np.zeros(n, np.int64),
                        np.zeros((n, 2), np.uint64), None)


def _pipes(seed=7, **kw):
    mine = UnionSamplePipeline(_Stub(SampleSet, seed), TokenEncoder(ATTRS, 512),
                               batch=3, seq_len=48, **kw)
    ref = RPipeline(_Stub(RSampleSet, seed), RTokenEncoder(ATTRS, 512),
                    batch=3, seq_len=48, **kw)
    return mine, ref


def _state(pipe):
    st = pipe.state_dict()
    st["stats"] = {k: v for k, v in st["stats"].items()
                   if k != "sample_seconds"}
    return st


def test_pipeline_batches_and_state_equal_reference():
    mine, ref = _pipes(host_rank=1, host_world=2)
    for _ in range(3):
        for g, w in zip(mine.next_batch(), ref.next_batch()):
            np.testing.assert_array_equal(g, w)
    assert _state(mine) == _state(ref)
    assert mine.stats.batches == 3 and mine.stats.tuples == 3 * 27
    # restoring the state resumes the same stream, in both packages
    saved = [json.loads(json.dumps(p.state_dict())) for p in (mine, ref)]
    first = [[p.next_batch() for _ in range(2)] for p in (mine, ref)]
    for p, st in zip((mine, ref), saved):
        p.load_state_dict(st)
    again = [[p.next_batch() for _ in range(2)] for p in (mine, ref)]
    for a, b in zip(first, again):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x[0], y[0])
    for x, y in zip(first[0], first[1]):
        np.testing.assert_array_equal(x[0], y[0])
    for got, want in zip(SyntheticPipeline(512, 2, 16, seed=3).next_batch(),
                         RSynthetic(512, 2, 16, seed=3).next_batch()):
        np.testing.assert_array_equal(got, want)


def test_pipeline_prefetch_and_deadline_skip():
    sync, _ = _pipes()
    pre, _ = _pipes()
    try:
        for _ in range(3):
            for g, w in zip(pre.next_batch_prefetched(), sync.next_batch()):
                np.testing.assert_array_equal(g, w)
    finally:
        pre.stop()
    slow = UnionSamplePipeline(_Stub(SampleSet, 1, delay=0.5),
                               TokenEncoder(ATTRS, 512), batch=1, seq_len=16,
                               deadline_s=0.01)
    try:
        assert slow.next_batch_prefetched() is None
        assert slow.stats.skipped == 1
    finally:
        slow.stop()
    bad = UnionSamplePipeline(_Stub(SampleSet, 1, fail=True),
                              TokenEncoder(ATTRS, 512), batch=1, seq_len=16)
    with pytest.raises(RuntimeError, match="worker failed"):
        bad.next_batch_prefetched()
    bad._thread.join(timeout=10)
    assert not bad._thread.is_alive()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _np_state(seed=0):
    rng = np.random.default_rng(seed)
    return {"step": np.asarray(3, np.int32),
            "params": {"w": rng.standard_normal((4, 5)).astype(np.float32),
                       "blocks.b": rng.standard_normal((2, 5)).astype(
                           np.float32)},
            "opt": {"m.w": np.zeros((4, 5), np.float32)}}


def _torch_state(seed=0):
    return {k: ({n: torch.as_tensor(a) for n, a in v.items()}
                if isinstance(v, dict) else torch.as_tensor(v))
            for k, v in _np_state(seed).items()}


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def test_checkpoint_roundtrip_gc_latest_and_corruption(tmp_path):
    ck = Checkpointer(str(tmp_path / "a"))
    st = _torch_state()
    ck.save(3, st, {"rng": [1, 2, 3], "x": np.int64(4)})
    assert ck.latest_step() == 3
    got, pp = ck.restore()
    assert pp == {"rng": [1, 2, 3], "x": 4}
    for k, v in _leaves(st).items():
        g = _leaves(got)[k]
        assert isinstance(g, torch.Tensor) and g.dtype == v.dtype
        assert torch.equal(g, v), k
    assert not os.path.exists(tmp_path / "a" / "step_00000003.tmp")

    ck = Checkpointer(str(tmp_path / "b"), keep=2)
    for s in (1, 2, 3, 4):
        st = _torch_state(s)
        st["step"] = torch.tensor(s)
        ck.save(s, st)
    steps = sorted(d for d in os.listdir(tmp_path / "b")
                   if d.startswith("step_"))
    assert steps == ["step_00000003", "step_00000004"]
    assert ck.latest_step() == 4
    assert int(ck.restore()[0]["step"]) == 4

    ck = Checkpointer(str(tmp_path / "c"))
    ck.save(1, _torch_state())
    d = tmp_path / "c" / "step_00000001"
    fn = sorted(f for f in os.listdir(d) if f.endswith(".npy"))[0]
    np.save(d / fn, np.load(d / fn) + 1)
    with pytest.raises(IOError, match="corruption"):
        ck.restore(1)
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "d")).restore()


def test_checkpoints_interchange_with_reference(tmp_path):
    """The port's float32/int checkpoint restores in the reference's
    ``Checkpointer`` and the other way round, with the same manifest."""
    Checkpointer(str(tmp_path / "p")).save(3, _torch_state(), {"a": 1})
    RCheckpointer(str(tmp_path / "r")).save(3, _np_state(), {"a": 1})
    mans = [json.load(open(tmp_path / d / "step_00000003" / "manifest.json"))
            for d in ("p", "r")]
    assert mans[0] == mans[1]
    got, pp = RCheckpointer(str(tmp_path / "p")).restore()
    assert pp == {"a": 1}
    for k, v in _leaves(_np_state()).items():
        np.testing.assert_array_equal(np.asarray(_leaves(got)[k]), v)
        assert np.asarray(_leaves(got)[k]).dtype == v.dtype
    got, _ = Checkpointer(str(tmp_path / "r")).restore(device="cpu")
    for k, v in _leaves(_np_state()).items():
        assert torch.equal(_leaves(got)[k], torch.as_tensor(v)), k


def test_checkpoint_bf16_leaf_is_bit_exact(tmp_path):
    import hashlib
    g = torch.Generator().manual_seed(0)
    m = (torch.randn((6, 7), generator=g) * 1e3).to(torch.bfloat16)
    m[0, :3] = torch.tensor([float("inf"), -0.0, 1e-40])
    st = {"step": torch.tensor(5, dtype=torch.int32),
          "opt": {"m.w": m, "v.w": torch.rand((6, 7), generator=g)}}
    ck = Checkpointer(str(tmp_path))
    ck.save(5, st)
    info = json.load(open(tmp_path / "step_00000005" / "manifest.json")
                     )["leaves"]["opt/m.w"]
    assert info["dtype"] == "bfloat16" and info["shape"] == [6, 7]
    assert info["hash"] == hashlib.blake2b(
        m.view(torch.int16).numpy().tobytes(), digest_size=8).hexdigest()
    got, _ = ck.restore(device="cpu")
    assert got["opt"]["m.w"].dtype == torch.bfloat16
    assert torch.equal(got["opt"]["m.w"].view(torch.int16),
                       m.view(torch.int16))
    assert torch.equal(got["opt"]["v.w"], st["opt"]["v.w"])
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 5


# ---------------------------------------------------------------------------
# the fault-tolerant supervisor (the reference's tests/test_infra.py:77, :108)
# ---------------------------------------------------------------------------


def test_supervisor_restart_after_failure(tmp_path):
    ck = Checkpointer(str(tmp_path))
    hb = str(tmp_path / "heartbeat")

    def step_fn(state, batch):
        return {"step": state["step"] + 1,
                "params": {"w": state["params"]["w"] + 1.0}}, {"loss": 0.0}

    failed = {"done": False}

    def injector(step):
        if step == 7 and not failed["done"]:
            failed["done"] = True
            raise RuntimeError("simulated preemption")

    sup = TrainSupervisor(step_fn, lambda: {"x": np.zeros(2)}, ck,
                          FTConfig(checkpoint_every=2, max_restarts=3,
                                   heartbeat_path=hb))
    out = sup.run({"step": torch.tensor(0), "params": {"w": torch.zeros(3)}},
                  10, fail_injector=injector)
    assert int(out["step"]) == 10
    assert sup.stats.restarts == 1 and sup.stats.checkpoints == 5
    # each step +1 and the restart resumed from the step-6 checkpoint
    assert torch.equal(out["params"]["w"], torch.full((3,), 10.0))
    assert os.path.exists(hb)

    def always(step):
        raise RuntimeError("down")
    sup = TrainSupervisor(step_fn, lambda: 1, Checkpointer(
        str(tmp_path / "x")), FTConfig(max_restarts=3))
    with pytest.raises(RuntimeError, match="down"):
        sup.run({"step": torch.tensor(0), "params": {"w": torch.zeros(1)}},
                2, fail_injector=always)


def test_supervisor_straggler_skip(tmp_path):
    n = {"i": 0}

    def next_batch():
        n["i"] += 1
        return None if n["i"] % 3 == 0 else {"x": 1}  # every 3rd batch late

    def step_fn(state, batch):
        return {"step": state["step"] + 1}, {}

    sup = TrainSupervisor(step_fn, next_batch, Checkpointer(str(tmp_path)),
                          FTConfig(checkpoint_every=100))
    out = sup.run({"step": torch.tensor(0)}, 6)
    assert int(out["step"]) == 6
    assert sup.stats.skipped_batches >= 2


# ---------------------------------------------------------------------------
# the train CLI against the reference's
# ---------------------------------------------------------------------------

STEP_LINE = re.compile(r"^step +(\d+)  loss (\d+\.\d{4})  lr (\S+)  "
                       r"pipeline: (\d+) tuples \(\d+\.\ds sampling\)$")
DONE_LINE = re.compile(r"^done: (\d+) steps in \d+\.\ds \(\d+\.\d\ds/step\); "
                       r"loss (\d+\.\d{4}) -> (\d+\.\d{4}); checkpoints=(\d+)$")


def _parse(text):
    lines = text.strip().splitlines()
    steps = [STEP_LINE.match(ln) for ln in lines[:-1]]
    done = DONE_LINE.match(lines[-1])
    assert all(steps) and done, text
    return ([(int(m[1]), float(m[2]), m[3], int(m[4])) for m in steps],
            (int(done[1]), float(done[2]), float(done[3]), int(done[4])))


def test_train_cli_equals_reference(monkeypatch, capsys, tmp_path):
    """``--smoke --device cpu --steps 3 --scale 0.01``: the reference's
    line format, its losses on shared weights and batches, and the same
    checkpoint leaves."""
    arch = "unionlm-100m"
    rcfg = dataclasses.replace(rconfigs.get_smoke_config(arch),
                               dtype="float32")
    pcfg = dataclasses.replace(pconfigs.get_smoke_config(arch),
                               dtype="float32")
    rparams = rtrans.init_params(rcfg, seed=0)
    nparams = {k: np.asarray(v) for k, v in rparams.items()}
    argv = ["--smoke", "--steps", "3", "--scale", "0.01", "--log-every", "1",
            "--checkpoint-every", "2"]
    monkeypatch.setattr(rtrain, "get_smoke_config", lambda a: rcfg)
    monkeypatch.setattr(rtrans, "init_params", lambda cfg, seed=0: rparams)
    rtrain.main(argv + ["--checkpoint-dir", str(tmp_path / "r")])
    want = _parse(capsys.readouterr().out)

    def init_state(cfg, tc, seed=0, device=None):
        params = params_from_numpy(cfg, nparams, device, dtype=torch.float32)
        return {"step": torch.zeros((), dtype=torch.int32, device=device),
                "params": params, "opt": init_opt_state(tc.opt, params)}
    monkeypatch.setattr(ptrain, "get_smoke_config", lambda a: pcfg)
    monkeypatch.setattr(ptrain, "init_train_state", init_state)
    monkeypatch.setattr(ptrain, "SetUnionSampler",
                        functools.partial(SetUnionSampler, backend="numpy"))
    out = ptrain.main(argv + ["--device", "cpu", "--checkpoint-dir",
                              str(tmp_path / "p")])
    got = _parse(capsys.readouterr().out)
    assert [s[0] for s in got[0]] == [s[0] for s in want[0]] == [1, 2, 3]
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g[1], w[1], **F32)
        assert g[2:] == w[2:]                       # lr and tuples drawn
    assert got[1][0] == want[1][0] == 3 and got[1][3] == want[1][3] == 1
    np.testing.assert_allclose(got[1][1:3], want[1][1:3], **F32)
    np.testing.assert_allclose(out["losses"], [s[1] for s in want[0]],
                               atol=5e-5 + 1e-4)
    assert out["ft"].completed_steps == 3 and int(out["state"]["step"]) == 3
    mans = [json.load(open(tmp_path / d / "step_00000002" / "manifest.json"))
            for d in ("p", "r")]
    assert {k: (v["shape"], v["dtype"]) for k, v in mans[0]["leaves"].items()
            } == {k: (v["shape"], v["dtype"])
                  for k, v in mans[1]["leaves"].items()}
    pp = json.load(open(tmp_path / "p" / "step_00000002" / "pipeline.json"))
    rp = json.load(open(tmp_path / "r" / "step_00000002" / "pipeline.json"))
    assert pp["rng_state"] == rp["rng_state"]


def test_train_cli_runs_its_own_engine(capsys, tmp_path):
    """The CLI as a user runs it on the CPU (the device engine on CPU
    tensors, its own initial state): the reference's lines, a falling
    loss."""
    out = ptrain.main(["--smoke", "--device", "cpu", "--steps", "3",
                       "--scale", "0.01", "--arch", "gemma2-9b",
                       "--checkpoint-dir", str(tmp_path)])
    steps, done = _parse(capsys.readouterr().out)
    assert [s[0] for s in steps] == [1] and done[0] == 3
    assert out["losses"][-1] < out["losses"][0]
    assert out["pipeline"].stats.batches == 3
    assert out["pipeline"].sampler.engine is not None
