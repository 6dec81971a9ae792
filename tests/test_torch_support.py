"""Shared helpers of the other tests/test_torch_*.py files (no tests here).

* :func:`to_port` — hands a reference workload to the port as plain numpy
  arrays through :func:`repro_torch.interop.workload_from_numpy`, §8.3
  predicates and pushdown provenance included.
* :class:`JaxReplay` — a uniform source for the port that replays the
  reference's JAX key schedule (``split(key)`` per round, then
  ``split(kround, nj+1)`` and per join ``split(k, n_streams)`` +
  ``uniform``), so the port reproduces the reference position for position.
* :class:`JaxRecordReplay` — the same for the record engine, whose rounds
  split ``split(key)`` into ``nj`` join keys and draw no selection slot.
* :func:`tree_uniforms` — the ``(n_streams, batch)`` uniforms
  ``DeviceTreeJoin.draw(key, batch)`` consumes.
* :class:`JaxWalkReplay` — the walk stream of ``JaxEstimator.observe``:
  ``split(key)`` per walk batch, then ``split(sub, n_hops+1)`` into the root
  ``randint`` and one ``uniform`` per hop (``DeviceWalkJoin.draw``).
* :class:`JaxSourceReplay` — the rounds of ``JaxCandidateSource``:
  ``split(key)`` per refill, then the ``DeviceTreeJoin.draw`` schedule.
* :class:`JaxSourcesReplay` — every join's source as ``JaxBackend``
  seeds them (join ``i`` from ``seed + i``): the baseline samplers.
* :class:`JaxOnlineReplay` — both for ``OnlineUnionSampler``: the
  estimator's walks from ``seed + 1`` and join ``i``'s source from
  ``seed + i``, as the reference seeds them.
"""

import jax
import numpy as np
import torch

from repro_torch.interop import workload_from_numpy


def _preds(preds):
    return [(p.attr, p.op, p.value) for p in preds]


def to_port(joins, cover=None):
    rels, specs = {}, []

    def nodes_of(j):
        nodes = []
        for n in j.nodes:
            rels[n.relation.name] = dict(n.relation.columns)
            nodes.append((n.alias, n.relation.name, n.parent,
                          tuple(n.edge_attrs), n.kind))
        return nodes

    for j in joins:
        preds = {"pushed_preds": _preds(j.pushed_preds),
                 "reject_preds": _preds(j.reject_preds)}
        if j.pushdown_base is not None:
            preds["pushdown_base"] = (j.pushdown_base.name,
                                      nodes_of(j.pushdown_base))
        specs.append((j.name, nodes_of(j), preds))
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


class JaxRecordReplay:
    """Uniform source replaying ``JaxRecordUnionSampler``'s round keys."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def round(self, slot, shapes):
        assert slot == 0
        self.key, sub = jax.random.split(self.key)
        keys = jax.random.split(sub, len(shapes))
        return (torch.zeros(0),
                [tree_uniforms(k, s, b) for k, (s, b) in zip(keys, shapes)])


class JaxWalkReplay:
    """Walk stream replaying ``JaxEstimator``'s keys (``walk`` method)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def walk(self, n_root, n_hops, batch):
        self.key, sub = jax.random.split(self.key)
        keys = jax.random.split(sub, n_hops + 1)
        r_pos = np.asarray(jax.random.randint(keys[0], (batch,), 0,
                                              max(n_root, 1)))
        u = np.stack([np.asarray(jax.random.uniform(k, (batch,)))
                      for k in keys[1:]]) if n_hops else \
            np.zeros((0, batch), np.float32)
        return (torch.from_numpy(r_pos.astype(np.int64)),
                torch.from_numpy(u.astype(np.float32)))


class JaxSourceReplay:
    """Round stream replaying ``JaxCandidateSource``'s keys (``tree``)."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)

    def tree(self, streams, batch):
        self.key, sub = jax.random.split(self.key)
        return tree_uniforms(sub, streams, batch)


class JaxSourcesReplay:
    """The candidate sources of ``JaxBackend(seed=seed)``: join ``i``'s
    rounds from ``seed + i`` (the baseline samplers' streams)."""

    def __init__(self, seed):
        self.seed = seed

    def source(self, i):
        return JaxSourceReplay(self.seed + i)


class JaxOnlineReplay(JaxWalkReplay, JaxSourcesReplay):
    """``OnlineUnionSampler``'s streams: walks from ``seed + 1``, the source
    of join ``i`` from ``seed + i``."""

    def __init__(self, seed):
        JaxWalkReplay.__init__(self, seed + 1)
        JaxSourcesReplay.__init__(self, seed)


def sample_multiset(ss):
    """(row, home) pairs of a SampleSet in a canonical order."""
    m = np.concatenate([ss.matrix(), ss.home[:, None]], axis=1)
    return m[np.lexsort(m.T[::-1])]
