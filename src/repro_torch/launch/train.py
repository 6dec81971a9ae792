r"""End-to-end training entry point of the port: union-of-joins sample stream →
LM training, on the card unless ``--device cpu``.

The paper's loop in production form, as the reference's
``repro/launch/train.py``: build the workload (TPC-H-lite union of joins),
warm up the estimators, run Algorithm 1 (``SetUnionSampler``) or 2
(``OnlineUnionSampler``, ``--online``) on the device engine as the data
source, encode tuples to token batches on the host, move each batch to the
device once per step, and train under the fault-tolerant supervisor with
periodic checkpoints::

    PYTHONPATH=src python -m repro_torch.launch.train --arch unionlm-100m \
        --workload UQ3 --steps 200 --batch 8 --seq 256 --warmup histogram
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --steps 3 --scale 0.01

``--arch`` takes every id of :mod:`repro_torch.configs` (``--smoke``: the
reduced config).  The batches carry tokens and targets only, as the
reference's do, so the encdec and vlm configs (whisper, paligemma) fail at
the first step with a ``KeyError`` naming the missing frontend, where the
reference's CLI fails.  It prints the
reference's step lines (step, loss, lr, tuples drawn and seconds spent
sampling) and its closing line; checkpoints go to ``--checkpoint-dir``
(default: ``repro_torch_ckpt`` under the temporary directory).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
import time
from typing import Dict, Optional

import torch

from ..checkpoint.checkpointer import Checkpointer
from ..configs import get_config, get_smoke_config
from ..core.framework import estimate_union, warmup
from ..core.online import OnlineUnionSampler
from ..core.union_sampler import SetUnionSampler
from ..data.encode import TokenEncoder
from ..data.pipeline import UnionSamplePipeline
from ..data.workloads import WORKLOADS
from ..device import resolve_device
from ..train.optimizer import OptConfig, default_opt_for
from ..train.train_step import TrainConfig, init_train_state, make_train_step
from .ft import FTConfig, TrainSupervisor


def build_pipeline(workload: str, scale: float, seed: int, batch: int,
                   seq: int, vocab: int, warm: str, online: bool,
                   device=None) -> UnionSamplePipeline:
    """Workload → warm-up (``warm``: exact, histogram or random_walk) →
    cover → ``SetUnionSampler``, or ``OnlineUnionSampler`` when ``online``,
    on ``device`` (``None``: the card) → token pipeline.  On the card the
    sampler is built under a CUDA stream of its own, which its engine pins
    (see :mod:`repro_torch.data.pipeline`)."""
    dev = resolve_device(device)
    wl = WORKLOADS[workload](scale=scale, seed=seed)
    stream = (torch.cuda.stream(torch.cuda.Stream(dev))
              if dev.type == "cuda" else contextlib.nullcontext())
    with stream:
        if online:
            sampler = OnlineUnionSampler(wl.cat, wl.joins, seed=seed,
                                         device=dev)
        else:
            wr = warmup(wl.cat, wl.joins, method=warm, device=dev,
                        **({"rw_max_walks": 4000} if warm == "random_walk"
                           else {}))
            est = estimate_union(wr.oracle)
            sampler = SetUnionSampler(wl.cat, wl.joins, est.cover, seed=seed,
                                      device=dev)
    enc = TokenEncoder(sorted(wl.joins[0].output_attrs), vocab_size=vocab)
    return UnionSamplePipeline(sampler, enc, batch=batch, seq_len=seq)


def main(argv: Optional[list] = None) -> Dict[str, object]:
    """Run the CLI; returns the losses, the per-step seconds (host clock
    around each train step, synchronised by its loss read), the whole run's
    seconds, tokens per step, the supervisor's stats and, for callers that
    go on training, the final ``state``, the ``train_step`` and the
    ``pipeline``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="unionlm-100m")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config for the arch")
    ap.add_argument("--workload", default="UQ3", choices=list(WORKLOADS))
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--warmup", default="histogram",
                    choices=["exact", "histogram", "random_walk"])
    ap.add_argument("--online", action="store_true",
                    help="use ONLINE-UNION (Algorithm 2) as the data source")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    pipe = build_pipeline(args.workload, args.scale, args.seed, args.batch,
                          args.seq, cfg.vocab, args.warmup, args.online, dev)

    tc = TrainConfig(opt=OptConfig(kind=default_opt_for(args.arch).kind,
                                   lr=args.lr),
                     warmup_steps=max(args.steps // 20, 2),
                     total_steps=args.steps)
    state = init_train_state(cfg, tc, seed=args.seed, device=dev)
    train_step = make_train_step(cfg, tc)

    losses, step_s = [], []

    def step_fn(state, batch):
        t0 = time.perf_counter()
        toks, tgts = batch
        state, metrics = train_step(state, {
            "tokens": torch.as_tensor(toks, device=dev),
            "targets": torch.as_tensor(tgts, device=dev)})
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t0)
        s = int(state["step"])
        if s % args.log_every == 0 or s == 1:
            print(f"step {s:5d}  loss {losses[-1]:.4f}  "
                  f"lr {float(metrics['lr']):.2e}  "
                  f"pipeline: {pipe.stats.tuples} tuples "
                  f"({pipe.stats.sample_seconds:.1f}s sampling)", flush=True)
        return state, metrics

    ckpt = Checkpointer(args.checkpoint_dir)
    sup = TrainSupervisor(step_fn, pipe.next_batch, ckpt,
                          FTConfig(checkpoint_every=args.checkpoint_every),
                          pipeline_state_fn=pipe.state_dict,
                          restore_pipeline_fn=pipe.load_state_dict)
    t0 = time.time()
    state = sup.run(state, args.steps)
    dt = time.time() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({dt/args.steps:.2f}s/step); loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"checkpoints={sup.stats.checkpoints}", flush=True)
    return {"losses": losses, "step_seconds": step_s, "seconds": dt,
            "tokens_per_step": args.batch * args.seq, "ft": sup.stats,
            "state": state, "train_step": train_step, "pipeline": pipe}


if __name__ == "__main__":
    main()
