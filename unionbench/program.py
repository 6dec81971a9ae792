"""The program under test (``repro_torch``), built from the benchmark's
inputs through its public constructors: ``Relation``, ``Catalog``,
``chain_join``, ``JoinSpec``/``JoinNode``, ``Pred`` and ``pushdown``, then
the warm-up, the cover and the sampler that the configuration names.
Nothing here reads the program's state back except counters and kernel
names."""

from __future__ import annotations

import time
from typing import Dict, Tuple


def load_kernels(run) -> None:
    """Build (first run in a checkout) or load the program's kernel
    library, in a span of its own."""
    if getattr(run.device, "type", str(run.device)) != "cuda":
        return
    from repro_torch.kernels import build
    with run.spans.span("build.kernels_s"):
        build.load()


def specs(union):
    """(catalog, join specs in cover order) of the union.  A chain is built
    with ``chain_join``, any other join (a branching tree, residual nodes)
    with ``JoinSpec`` over ``JoinNode``s.  Joins over the same relations
    with the same nodes share their unfiltered spec, and relations a join
    keeps whole are the base ``Relation`` objects (and so share the
    program's per-relation device tensors), as its own UQ2 builder does."""
    from repro_torch.core.index import Catalog
    from repro_torch.core.predicates import Pred, pushdown
    from repro_torch.core.relation import Relation

    base = {name: Relation(name, dict(cols))
            for name, cols in union.relations.items()}
    shared: Dict[Tuple, object] = {}
    out = []
    for k, j in enumerate(union.joins):
        nodes = union.nodes(k)
        rels = []
        for node in nodes:
            m = j.masks.get(node.relation)
            rel = base[node.relation]
            rels.append(rel if m is None
                        else rel.filter(m, name=f"{node.relation}@{j.name}"))
        chain = union.is_chain(k)
        if not j.preds:
            out.append(_join_spec(j.name, nodes, rels, chain))
            continue
        ident = tuple((id(r), n.parent, n.edge, n.kind)
                      for r, n in zip(rels, nodes))
        if ident not in shared:
            shared[ident] = _join_spec(f"{j.name}#base", nodes, rels, chain)
        out.append(pushdown(shared[ident],
                            [Pred(a, op, set(v) if op == "in" else v)
                             for a, op, v in j.preds], name=j.name))
    return Catalog(), out


def _join_spec(name: str, nodes, rels, chain: bool):
    from repro_torch.core.joins import JoinNode, JoinSpec, chain_join
    if chain:
        return chain_join(name, rels, [n.edge for n in nodes[1:]])
    return JoinSpec(name, [JoinNode(n.relation, r, n.parent, n.edge, n.kind)
                           for n, r in zip(nodes, rels)])


def cover(config, cat, joins, seed: int, device):
    """Warm-up and cover as the configuration says, in the joins' order."""
    from repro_torch.core.framework import estimate_union, warmup
    kw = dict(config["warmup"])
    method = kw.pop("method")
    if method == "random_walk":
        kw.update(seed=seed, device=device)
    wr = warmup(cat, joins, method=method, **kw)
    return estimate_union(wr.oracle, order=[j.name for j in joins]).cover


def set_union_sampler(config, cat, joins, cov, seed: int, device):
    from repro_torch.core.union_sampler import SetUnionSampler
    return SetUnionSampler(cat, joins, cov, seed=seed, backend="torch",
                           device=device, round_batch=config["round_batch"],
                           plan=config["plan"],
                           fused_rounds=config.get("fused_rounds"))


def online_sampler(config, cat, joins, seed: int, device):
    from repro_torch.core.online import OnlineUnionSampler
    on = config["online"]
    return OnlineUnionSampler(cat, joins, seed=seed, backend="torch",
                              device=device, phi=on["phi"],
                              rw_batch=on["rw_batch"],
                              order=[j.name for j in joins])


class TimedEngine:
    """The engine as ``SampleService`` sees it, with the seconds the
    producer spends inside it (``sample``, ``sample_async`` and the
    handle's ``result``) counted in ``busy``.  ``label`` wraps each call
    (a profiler range when tracing)."""

    def __init__(self, sampler, label):
        self._s = sampler
        self._label = label
        self.attrs = list(sampler.attrs)
        self._busy = 0.0
        self._since = None          # start of the call in progress

    @property
    def stats(self):
        return self._s.stats

    def busy(self) -> Tuple[float, float]:
        """(seconds inside the engine so far, the call in progress
        included; the clock they were read at)."""
        now = time.perf_counter()
        since = self._since
        return self._busy + (0.0 if since is None else now - since), now

    def idle(self) -> bool:
        return self._since is None

    def timed(self, name: str, fn, *a):
        self._since = time.perf_counter()
        try:
            with self._label(name):
                return fn(*a)
        finally:
            end, since = time.perf_counter(), self._since
            self._since = None
            self._busy += end - since

    def sample(self, n: int):
        return self.timed("engine.sample", self._s.sample, n)

    def sample_async(self, n: int):
        return _TimedHandle(self.timed("engine.dispatch",
                                       self._s.sample_async, n), self)


class _TimedHandle:
    def __init__(self, handle, engine: TimedEngine):
        self._h, self._e = handle, engine

    def result(self):
        return self._e.timed("engine.result", self._h.result)


class TimedCall:
    """A callable wrapped to count its calls and seconds."""

    def __init__(self, fn, label, name: str):
        self.fn, self.label, self.name = fn, label, name
        self.calls, self.seconds = 0, 0.0

    def __call__(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            with self.label(self.name):
                return self.fn(*a, **kw)
        finally:
            self.calls += 1
            self.seconds += time.perf_counter() - t0


def stat_counters(stats) -> Dict[str, float]:
    return {k: float(v) for k, v in stats.as_dict().items()}

