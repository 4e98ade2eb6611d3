"""The port's tracer (``repro_torch.obs``) and what the fused search
records with it.

On the CPU: spans nest per thread, tracing off is one shared no-op, an
export passes the Chrome-trace schema check, an evaluation's density
and reuse-prefix histograms reach the export's metrics, and a fused
search's span tree is ``search.run`` over ``search.prepare``, one
``search.chunk`` (each over ``engine.eval`` and ``search.fold``) a
chunk, then ``search.validate``, with no ``device_s`` (no CUDA events
on the CPU); its ``engine.*`` spans name the density kinds the program
holds, and a capture of a program that evaluates a causal tensor
observes its kernel count on ``fused.graph_kernels.causal`` too (the
observation, given a count, on the CPU).  The ``gpu`` cases run the
search as a captured graph: ``device_s`` lies in (0, the span's
length], each capture observes its graph's kernel count once, and
tracing changes no number of the search's log.
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
WL_CAUSAL = matmul(32, 32, 32, densities={
    "A": ("causal", {"rows": 32, "cols": 32, "window": 8}),
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


def _fused(device, key=5, wl=WL):
    return run_search(DESIGN, wl, CONS, strategy="es", key=key, fused=True,
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


def test_density_histograms_in_the_metrics_export(tracer, tmp_path):
    """One evaluation observes the engine's density queries and
    statistics evaluations, and its reuse-prefix pairs and reads; the
    four histograms reach the export's metrics snapshot."""
    from repro_torch.core import Sparseloop
    from repro_torch.core.mapping import Loop, LoopNest
    nest = LoopNest(loops=(Loop("m", 32, 1), Loop("n", 8, 1),
                           Loop("n", 4, 1, True), Loop("k", 32, 0)),
                    num_levels=2)
    out = Sparseloop(DESIGN, device="cpu").evaluate_batch(
        WL, [nest], check_capacity=False)
    assert out["cycles"].shape == (1,)
    assert tracer.find("engine.compile") or tracer.find("engine.eval")
    path = obs.write_chrome_trace(tmp_path / "trace.json", tracer.spans,
                                  obs.metrics.snapshot())
    assert obs.validate_chrome_trace_file(path) == []
    events = json.loads(open(path).read())["traceEvents"]
    snap, = [e["args"] for e in events if e["name"] == "metrics"]
    queries = snap["engine.density_queries"]
    evals = snap["engine.density_evals"]
    assert queries["kind"] == evals["kind"] == "histogram"
    assert queries["count"] >= 1 and evals["count"] >= 1
    assert queries["max"] > evals["max"] > 0
    pairs = snap["engine.prefix_pairs"]
    reads = snap["engine.prefix_reads"]
    assert pairs["kind"] == reads["kind"] == "histogram"
    assert pairs["count"] >= 1 and reads["count"] >= 1
    assert reads["max"] > pairs["max"] > 0


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


@pytest.mark.parametrize("wl, kinds", [(WL, ("dense", "uniform")),
                                       (WL_CAUSAL,
                                        ("causal", "dense", "uniform"))],
                         ids=["uniform", "causal"])
def test_fused_spans_name_the_programs_density_kinds(tracer, wl, kinds):
    """The first chunk's ``engine.compile`` and every later chunk's
    ``engine.eval`` carry the sorted kinds of the workload's tensors
    (the output Z dense)."""
    clear_caches()
    _fused("cpu", wl=wl)
    spans = [s for s in tracer.spans
             if s.name in ("engine.compile", "engine.eval")
             and s.attrs.get("kind") == "fused"]
    assert {s.name for s in spans} == {"engine.compile", "engine.eval"}
    assert all(tuple(s.attrs["density_kinds"]) == kinds for s in spans)


def test_a_causal_capture_observes_both_kernel_histograms(monkeypatch):
    """A capture's kernel count goes to ``fused.graph_kernels`` always
    and to ``fused.graph_kernels.causal`` where the program's workload
    holds a causal tensor (the capture itself needs a card: the count is
    given here)."""
    from repro_torch.core.batched import DeviceLeaves
    from repro_torch.core.density import CAUSAL_ID, UNIFORM_ID
    monkeypatch.setattr(obs.metrics, "REGISTRY", obs.metrics.Registry())
    F.FusedProgram._observe_kernels(
        2509, DeviceLeaves(*(None,) * 4, kinds=(UNIFORM_ID,) * 2))
    F.FusedProgram._observe_kernels(
        2600, DeviceLeaves(*(None,) * 4, kinds=(CAUSAL_ID, UNIFORM_ID)))
    snap = obs.metrics.snapshot()
    assert snap["fused.graph_kernels"]["count"] == 2
    causal = snap["fused.graph_kernels.causal"]
    assert (causal["count"], causal["mean"]) == (1, 2600.0)


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


@pytest.mark.gpu
def test_cuda_a_causal_capture_observes_its_kernel_count():
    dev = _card()
    clear_caches()

    def count(name):
        return obs.metrics.snapshot().get(name, {}).get("count", 0)
    plain, causal = count("fused.graph_kernels"), \
        count("fused.graph_kernels.causal")
    _fused(dev)
    assert count("fused.graph_kernels.causal") == causal
    _fused(dev, wl=WL_CAUSAL)
    assert count("fused.graph_kernels") - plain == 2
    assert count("fused.graph_kernels.causal") - causal == 1
