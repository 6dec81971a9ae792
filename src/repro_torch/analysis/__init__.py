"""Static invariant analysis for the port's union-sampling engine.

The counterpart of the reference's ``repro/analysis``.  Three layers guard
the invariants the runtime tests pin:

* **Layer 1 — AST lint** (:mod:`repro_torch.analysis.lint`,
  :mod:`repro_torch.analysis.rules`): stdlib-only rules over the
  ``src/repro_torch`` tree — host syncs inside the round that the device
  loop captures as a CUDA graph (the reference's jit-boundary rules),
  fixed-point discipline in the planner, nondeterminism in the captured
  round, int32 packed-key overflow guards, SamplerStats width agreement
  across the host/device/sharded carries, host-degrade branches that
  forget ``record_fallback``, and device-stat pulls on the online hot
  path.
* **Layer 2 — program audits** (:mod:`repro_torch.analysis.trace_audit`,
  :mod:`repro_torch.analysis.recompile`): drive the real engines on small
  workloads and check what source lint cannot see — no collective in the
  unsharded engine, the sharded loops' collectives per round, the same
  Philox stream consumed by the device and host loops, and one set of
  static buffers (on the card: one capture) per capacity class.
* **Layer 3 — concurrency lint** (:mod:`repro_torch.analysis.rules.locks`):
  lock discipline for the serve tier and the obs registry.

Layers 1 and 3 import only the standard library; layer 2 imports torch
lazily.  ``python -m repro_torch.analysis`` runs the gate
(:mod:`repro_torch.analysis.__main__`) against the package's baseline,
``baseline.json``.
"""

from .findings import Baseline, Finding  # noqa: F401
from .lint import run_lint  # noqa: F401
