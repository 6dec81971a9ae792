"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of the run driven on the CPU,
once for each fault a stream cell can have."""

import numpy as np
import pytest
import torch

from unionbench import harness, program
from unionbench.tests import support


@pytest.fixture(scope="module")
def pkg(tmp_path_factory):
    return support.tiny_copy(tmp_path_factory.mktemp("unionbench"))


class _Stuck:
    """An engine whose every call returns its first result: a step that
    returns its state unchanged."""

    def __init__(self, sampler):
        self._s, self._first = sampler, None
        self.attrs, self.engine = sampler.attrs, sampler.engine
        self.stats = sampler.stats

    def sample(self, n):
        if self._first is None:
            self._first = self._s.sample(n)
        return self._first

    def sample_async(self, n):
        ss = self.sample(n)
        return type("H", (), {"result": lambda self: ss})()


class _Altered(_Stuck):
    """An engine that changes one value in every 97th row it produces."""

    def sample(self, n):
        ss = self._s.sample(n)
        a = ss.attrs[-1]
        ss.rows[a] = ss.rows[a].copy()
        ss.rows[a][::97] += 1
        return ss


def _run(pkg, cell="uq1-sf1.stream"):
    return harness.execute(support.bench(), cell, support.SEED, 0.3, False,
                           torch.device("cpu"), pkg=pkg)


@pytest.mark.parametrize("fault,number", [(_Stuck, "dup_z"),
                                          (_Altered, "rows_not_in_home")])
def test_engine_faults_are_caught(pkg, monkeypatch, fault, number):
    build = program.set_union_sampler
    monkeypatch.setattr(program, "set_union_sampler",
                        lambda *a, **kw: fault(build(*a, **kw)))
    res = _run(pkg)
    assert not res["correct"]
    c = res["checks"][number]
    assert c["value"] > c["limit"]


def test_half_of_each_request_left_out_is_caught(pkg, monkeypatch):
    from repro_torch.serve import SampleService
    request = SampleService.request

    def half(self, n, timeout=120.0):
        ss = request(self, n, timeout)
        k = len(ss) // 2
        return type(ss)(ss.attrs, {a: c[:k] for a, c in ss.rows.items()},
                        ss.home[:k], ss.fingerprint[:k], ss.stats)
    monkeypatch.setattr(SampleService, "request", half)
    res = _run(pkg)
    assert not res["correct"]
    assert res["checks"]["request_size_errors"]["value"] > 0


def test_rows_credited_to_a_later_piece_are_caught(pkg, monkeypatch):
    """Every row's home moved one piece later: rows of piece k now lie in
    the earlier join k (or in no piece of their home)."""
    build = program.set_union_sampler

    class Shifted(_Stuck):
        def sample(self, n):
            ss = self._s.sample(n)
            ss.home = np.minimum(ss.home + 1, len(self._s.order) - 1)
            return ss
    monkeypatch.setattr(program, "set_union_sampler",
                        lambda *a, **kw: Shifted(build(*a, **kw)))
    res = _run(pkg)
    assert not res["correct"]
    assert res["checks"]["rows_in_earlier_piece"]["value"] > 0
