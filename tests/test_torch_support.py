"""Shared helpers of the other tests/test_torch_*.py files (no tests here).

* :func:`to_port` — hands a reference workload to the port as plain numpy
  arrays through :func:`repro_torch.interop.workload_from_numpy`.
* :class:`JaxReplay` — a uniform source for the port that replays the
  reference's JAX key schedule (``split(key)`` per round, then
  ``split(kround, nj+1)`` and per join ``split(k, n_streams)`` +
  ``uniform``), so the port reproduces the reference position for position.
* :func:`tree_uniforms` — the ``(n_streams, batch)`` uniforms
  ``DeviceTreeJoin.draw(key, batch)`` consumes.
"""

import jax
import numpy as np
import torch

from repro_torch.interop import workload_from_numpy


def to_port(joins, cover=None):
    rels, specs = {}, []
    for j in joins:
        nodes = []
        for n in j.nodes:
            rels[n.relation.name] = dict(n.relation.columns)
            nodes.append((n.alias, n.relation.name, n.parent,
                          tuple(n.edge_attrs), n.kind))
        specs.append((j.name, nodes))
    if cover is None:
        order = [j.name for j in joins]
        return workload_from_numpy(rels, specs, order, {n: 1.0 for n in order})
    return workload_from_numpy(rels, specs, cover.order, cover.piece_sizes,
                               cover.join_sizes)


def tree_uniforms(key, streams, batch):
    keys = jax.random.split(key, streams)
    return torch.from_numpy(np.stack(
        [np.asarray(jax.random.uniform(k, (batch,))) for k in keys]))


class JaxReplay:
    """Uniform source replaying ``JaxUnionSampler``'s device loop keys."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)
        self.rng = np.random.default_rng(seed)

    def round(self, slot, shapes):
        self.key, kround = jax.random.split(self.key)
        kpick, *jks = jax.random.split(kround, len(shapes) + 1)
        u_sel = torch.from_numpy(np.array(jax.random.uniform(kpick, (slot,))))
        return u_sel, [tree_uniforms(k, s, b) for k, (s, b) in zip(jks, shapes)]

    def permutation(self, n):
        return torch.from_numpy(self.rng.permutation(n))


def sample_multiset(ss):
    """(row, home) pairs of a SampleSet in a canonical order."""
    m = np.concatenate([ss.matrix(), ss.home[:, None]], axis=1)
    return m[np.lexsort(m.T[::-1])]
