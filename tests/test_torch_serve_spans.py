"""The program's spans read through the benchmark's harness on the CPU, at
the harness tests' tiny sizes: ``scripts/serve_spans.py`` adds the span
totals to the stream driver's counters, and its six per-layer quantities
come out of a traced run (five on the CPU: the CUDA-event counter reads
only on the card).  The engine's own spans agree with the time the
harness's proxy engine counts around the same calls."""

import importlib.util

import pytest
import torch

from repro_torch import obs
from unionbench.tests import support

SCRIPT = support.ROOT / "scripts" / "serve_spans.py"


@pytest.fixture(scope="module")
def serve_spans():
    spec = importlib.util.spec_from_file_location("serve_spans", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pkg(tmp_path_factory):
    return support.tiny_copy(tmp_path_factory.mktemp("unionbench"))


def test_traced_cpu_run_reads_the_host_side_quantities(serve_spans, pkg):
    line = serve_spans.run_cell(support.bench(), "uq2-sf1.stream",
                                support.SEED, 1.0, True, True,
                                torch.device("cpu"), pkg)
    assert line["correct"]
    layer = line["layer"]
    assert set(layer) == {"serve.queue_wait_share",
                          "serve.producer_park_share",
                          "serve.assemble_ms_per_request",
                          "loop.host_ms_per_ksample", "host.offcpu_share"}
    assert 0 <= layer["serve.queue_wait_share"] <= 100
    assert 0 <= layer["serve.producer_park_share"] <= 100
    assert 0 <= layer["host.offcpu_share"] <= 100
    assert layer["serve.assemble_ms_per_request"] > 0
    assert layer["loop.host_ms_per_ksample"] > 0
    spans = line["span_window"]
    engine = spans["loop.dispatch"]["s"] + spans["loop.result"]["s"]
    assert engine == pytest.approx(line["engine_busy_s"], rel=0.10)
    assert not obs.trace_annotations_enabled()      # switched back off


def test_spans_off_leave_the_quantities_out(serve_spans, pkg):
    line = serve_spans.run_cell(support.bench(), "uq1-sf1.stream",
                                support.SEED, 0.3, False, False,
                                torch.device("cpu"), pkg)
    assert line["correct"] and line["metrics"]["samples_per_s"] > 0
    assert line["layer"] == {} and line["span_window"] == {}
