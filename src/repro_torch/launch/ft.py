"""Fault tolerance: supervised training loop with checkpoint/restart,
heartbeat and straggler-skip.

The port's copy of the reference's ``repro/launch/ft.py``.
``TrainSupervisor`` wraps a step function the way a cluster-level launcher
would wrap a worker process:

* **checkpoint/restart** — on any step failure the supervisor restores the
  latest checkpoint (model + optimizer + data-pipeline RNG) onto the
  state's device and resumes; restart storms are bounded by
  ``max_restarts``.
* **heartbeat** — a monotonically-touched file; an external watchdog (or the
  unit test) detects hangs via mtime staleness.
* **straggler-skip** — if the data pipeline misses its deadline the batch is
  skipped and logged; the union-sample stream is i.i.d., so a skipped batch
  changes nothing statistically (the paper's guarantee doing systems work).

The state's ``"step"`` is an int or a 0-dim tensor; ``int(state["step"])``
reads it (one host sync per step on the card, as the reference's).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from ..checkpoint.checkpointer import Checkpointer


@dataclasses.dataclass
class FTConfig:
    checkpoint_every: int = 50
    max_restarts: int = 5
    heartbeat_path: Optional[str] = None
    batch_deadline_s: Optional[float] = None


@dataclasses.dataclass
class FTStats:
    restarts: int = 0
    skipped_batches: int = 0
    completed_steps: int = 0
    checkpoints: int = 0


class TrainSupervisor:
    def __init__(self, step_fn: Callable[[Any, Any], Any],
                 next_batch: Callable[[], Any],
                 checkpointer: Checkpointer, ft: FTConfig,
                 pipeline_state_fn: Optional[Callable[[], Dict]] = None,
                 restore_pipeline_fn: Optional[Callable[[Dict], None]] = None):
        self.step_fn = step_fn
        self.next_batch = next_batch
        self.ckpt = checkpointer
        self.ft = ft
        self.pipeline_state_fn = pipeline_state_fn
        self.restore_pipeline_fn = restore_pipeline_fn
        self.stats = FTStats()

    def _heartbeat(self) -> None:
        if self.ft.heartbeat_path:
            with open(self.ft.heartbeat_path, "w") as f:
                f.write(str(time.time()))

    def run(self, state: Any, n_steps: int,
            fail_injector: Optional[Callable[[int], None]] = None) -> Any:
        """Run ``n_steps`` with checkpoint/restart; returns final state.  A
        restore puts every leaf on the device of the state's step tensor
        (the host for an int step)."""
        step = state["step"]
        device = step.device if isinstance(step, torch.Tensor) else None
        target = int(step) + n_steps
        restarts = 0
        while int(state["step"]) < target:
            step = int(state["step"])
            try:
                if fail_injector is not None:
                    fail_injector(step)
                t0 = time.perf_counter()
                batch = self.next_batch()
                if (self.ft.batch_deadline_s is not None and
                        time.perf_counter() - t0 > self.ft.batch_deadline_s):
                    self.stats.skipped_batches += 1
                    continue
                if batch is None:          # pipeline-level straggler skip
                    self.stats.skipped_batches += 1
                    continue
                state, metrics = self.step_fn(state, batch)
                self.stats.completed_steps += 1
                self._heartbeat()
                new_step = int(state["step"])
                if new_step % self.ft.checkpoint_every == 0:
                    pp = self.pipeline_state_fn() if self.pipeline_state_fn else None
                    self.ckpt.save(new_step, state, pp)
                    self.stats.checkpoints += 1
            except Exception:
                restarts += 1
                self.stats.restarts += 1
                if restarts > self.ft.max_restarts:
                    raise
                latest = self.ckpt.latest_step()
                if latest is None:
                    # nothing saved yet: re-raise rather than loop forever
                    if restarts > 1:
                        raise
                    continue
                state, pp = self.ckpt.restore(latest, device=device)
                if pp is not None and self.restore_pipeline_fn is not None:
                    self.restore_pipeline_fn(pp)
        return state
