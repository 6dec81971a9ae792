"""Batched chain-join sampling on the card: the chain-shaped façade.

Port of ``repro.core.jax_sampler``.  The engine is
:class:`~repro_torch.core.backends.torch_backend.TorchTreeJoin`, which runs
the root draw → per-hop range probe (the CUDA kernels of
:mod:`repro_torch.kernels.probe`) → ranged pick program for any acyclic or
§8.2 cyclic join.  :class:`TorchChainSampler` keeps the reference's
chain-only API and validation on top of it.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .backends.torch_backend import PhiloxUniforms, TorchTreeJoin
from .index import Catalog
from .joins import JoinSpec


class TorchChainSampler:
    """EW sampler over a chain join on ``device`` (uniform, zero rejection).

    ``device=None`` means the card and raises without one.  ``uniforms``
    replaces the Philox stream seeded from ``seed``: an object whose
    ``tree(streams, batch)`` returns one batch's ``(streams, batch)``
    float32 uniforms (tests replay the reference's keys through it)."""

    def __init__(self, cat: Catalog, spec: JoinSpec, seed: int = 0,
                 device=None, uniforms=None):
        if spec.is_cyclic or not spec.is_chain:
            shape = "cyclic" if spec.is_cyclic else "non-chain acyclic"
            raise ValueError(
                f"TorchChainSampler: join {spec.name!r} is {shape}; this "
                "facade is chain-only — TorchTreeJoin in "
                "repro_torch.core.backends.torch_backend runs acyclic and "
                "cyclic (§8.2 skeleton+residual) joins on the device")
        self.spec = spec
        self.tree = TorchTreeJoin(cat, spec, device=device)
        self.device = self.tree.device
        self.attrs = tuple(spec.output_attrs)
        self.n_hops = len(self.tree.node_cfgs)
        self.uniforms = (uniforms if uniforms is not None
                         else PhiloxUniforms(seed, self.device))

    def sample_batch(self, batch: int
                     ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """``batch`` draws: host int64 rows and the ``ok`` mask (chains
        accept every walk that found a match at each hop)."""
        rows, ok, _ = self.tree.draw(self.uniforms.tree(self.tree.n_streams,
                                                        batch))
        # one device→host copy per batch
        mat = torch.stack([rows[a] for a in self.attrs]
                          + [ok.to(torch.int32)], dim=1).cpu().numpy()
        return ({a: mat[:, i].astype(np.int64)
                 for i, a in enumerate(self.attrs)}, mat[:, -1].astype(bool))

    def sample_uniform(self, n: int, batch: int = 4096,
                       max_rounds: int = 1000) -> Dict[str, np.ndarray]:
        got: List[Dict[str, np.ndarray]] = []
        count = 0
        for _ in range(max_rounds):
            rows, ok = self.sample_batch(batch)
            idx = np.nonzero(ok)[0]
            if idx.shape[0]:
                got.append({a: c[idx] for a, c in rows.items()})
                count += idx.shape[0]
            if count >= n:
                break
        else:
            raise RuntimeError("TorchChainSampler: round budget exhausted")
        return {a: np.concatenate([g[a] for g in got])[:n] for a in got[0]}
