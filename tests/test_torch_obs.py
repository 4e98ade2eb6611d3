"""The port's tracer (``repro_torch.obs``) and what the fused search
records with it.

On the CPU: spans nest per thread, tracing off is one shared no-op, an
export passes the Chrome-trace schema check, and a fused search's span
tree is ``search.run`` over ``search.prepare``, one ``search.chunk``
(each over ``engine.eval`` and ``search.fold``) a chunk, then
``search.validate``, with no ``device_s`` (no CUDA events on the CPU).
The ``gpu`` cases run the search as a captured graph: ``device_s`` lies
in (0, the span's length], each capture observes its graph's kernel
count once, and tracing changes no number of the search's log.
"""
import json
import math
import threading

import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.core import matmul  # noqa: E402
from repro_torch.core.batched import clear_caches  # noqa: E402
from repro_torch.core.mapper import MapspaceConstraints  # noqa: E402
from repro_torch.core.presets import (coordinate_list_design,  # noqa: E402
                                      two_level_arch)
from repro_torch.search import SearchConfig, run_search  # noqa: E402
from repro_torch.search import fused as F  # noqa: E402

WL = matmul(32, 32, 32, densities={"A": ("uniform", 0.3),
                                   "B": ("uniform", 0.3)})
DESIGN = coordinate_list_design(two_level_arch(buffer_kwords=8))
CONS = MapspaceConstraints(budget=96, seed=0, spatial={1: {"n": 4}})
GENS, CHUNK, POP = 5, 2, 64


@pytest.fixture
def tracer():
    """Tracing on for the test, off after it."""
    tr = obs.enable()
    try:
        yield tr
    finally:
        obs.disable()


def _fused(device, key=5):
    return run_search(DESIGN, WL, CONS, strategy="es", key=key, fused=True,
                      generations=GENS, pop_size=POP,
                      config=SearchConfig(fused_chunk=CHUNK), device=device)


def _children(spans, parent):
    """Spans directly under ``parent``, in start order."""
    return sorted((s for s in spans if s.tid == parent.tid
                   and s.depth == parent.depth + 1
                   and parent.t_start <= s.t_start
                   and s.t_end <= parent.t_end),
                  key=lambda s: s.t_start)


def _graph_kernels() -> int:
    return obs.metrics.snapshot().get("fused.graph_kernels",
                                      {}).get("count", 0)


# ----------------------------------------------------------------------
# the tracer
# ----------------------------------------------------------------------
def test_spans_nest_per_thread(tracer):
    barrier = threading.Barrier(3)

    def work(tag):
        with obs.span("outer", tag=tag):
            barrier.wait(timeout=10)
            with obs.span("inner", tag=tag) as sp:
                barrier.wait(timeout=10)
                sp.set(done=True)

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    with obs.span("main"):
        barrier.wait(timeout=10)
        barrier.wait(timeout=10)
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    spans = tracer.spans
    assert sorted(s.name for s in spans) == ["inner", "inner", "main",
                                             "outer", "outer"]
    for tag in "ab":
        outer, = [s for s in spans if s.name == "outer"
                  and s.attrs["tag"] == tag]
        inner, = [s for s in spans if s.name == "inner"
                  and s.attrs["tag"] == tag]
        assert (outer.depth, inner.depth) == (0, 1)
        assert inner.tid == outer.tid != threading.get_ident()
        assert outer.t_start <= inner.t_start <= inner.t_end <= outer.t_end
        assert inner.attrs["done"] is True
    assert tracer.find("main")[0].depth == 0
    assert len({s.tid for s in spans}) == 3
    assert obs.validate_chrome_trace(
        {"traceEvents": obs.chrome_trace_events(spans)}) == []


def test_tracing_off_is_one_shared_no_op():
    obs.disable()
    assert not obs.enabled() and obs.tracer() is None
    a, b = obs.span("a", x=1), obs.span("b")
    assert a is b
    with a as handle:
        handle.set(y=2)
    assert obs.tracer() is None


def test_an_export_passes_the_schema_check(tracer, tmp_path):
    with obs.span("outer"):
        with obs.span("inner", shape=(2, 3)):
            pass
    path = obs.write_chrome_trace(tmp_path / "trace.json", tracer.spans,
                                  {"m": {"value": 1.0}})
    assert obs.validate_chrome_trace_file(path) == []
    events = json.loads(open(path).read())["traceEvents"]
    inner, = [e for e in events if e["name"] == "inner"]
    assert inner["args"] == {"shape": [2, 3]} and inner["ph"] == "X"
    # a partial overlap on one track is reported
    bad = {"traceEvents": [
        {"name": "p", "ph": "X", "ts": 0, "dur": 10, "pid": 0, "tid": 0},
        {"name": "q", "ph": "X", "ts": 5, "dur": 10, "pid": 0, "tid": 0}]}
    assert any("unbalanced" in e for e in obs.validate_chrome_trace(bad))


# ----------------------------------------------------------------------
# the fused search's spans
# ----------------------------------------------------------------------
def test_fused_search_span_tree_on_the_cpu(tracer):
    clear_caches()
    _fused("cpu")                       # the program's first sighting
    tracer.spans.clear()
    res = _fused("cpu")
    spans = tracer.spans
    run, = [s for s in spans if s.name == "search.run"]
    assert run.depth == 0 and run.attrs["fused"] is True
    assert (run.attrs["generations"], run.attrs["pop_size"]) == (GENS, POP)
    names = [s.name for s in _children(spans, run)]
    chunks = math.ceil(GENS / CHUNK)
    assert names == (["search.prepare"] + ["search.chunk"] * chunks
                     + ["search.validate"])
    lengths = []
    for chunk in _children(spans, run)[1:-1]:
        ev, fold = _children(spans, chunk)
        assert (ev.name, fold.name) == ("engine.eval", "search.fold")
        assert ev.attrs["kind"] == "fused"
        assert ev.attrs["generations"] == chunk.attrs["length"]
        assert "device_s" not in ev.attrs
        lengths.append(chunk.attrs["length"])
    assert sum(lengths) == GENS == len(res.log.records)
    assert not any("device_s" in s.attrs for s in spans)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
def test_cuda_device_s_lies_inside_its_span(tracer):
    dev = _card()
    _fused(dev)
    tracer.spans.clear()
    _fused(dev)
    evals = [s for s in tracer.spans if s.name == "engine.eval"]
    assert len(evals) == math.ceil(GENS / CHUNK)
    for s in evals:
        assert 0.0 < s.attrs["device_s"] <= s.dur
        assert s.attrs["generations"] in (CHUNK, GENS % CHUNK)


@pytest.mark.gpu
def test_cuda_each_capture_observes_its_kernel_count():
    dev = _card()
    clear_caches()
    captures, observed = F.graph_captures(), _graph_kernels()
    _fused(dev)
    _fused(dev)
    assert F.graph_captures() - captures == 1
    assert _graph_kernels() - observed == 1
    kernels = obs.metrics.snapshot()["fused.graph_kernels"]
    assert kernels["min"] > 0


@pytest.mark.gpu
def test_cuda_tracing_changes_no_number_of_the_log():
    dev = _card()
    off = _fused(dev, key=11).log.to_json(timing=False)
    obs.enable()
    try:
        on = _fused(dev, key=11).log.to_json(timing=False)
    finally:
        obs.disable()
    assert on == off
