"""The readers of what a causal-operand program costs, on synthetic spans
and histograms: ``causal_graph_ms_per_gen`` (the fused ``engine.eval``
spans whose ``density_kinds`` hold ``causal``) and
``causal_graph_kernels`` (the always-on histogram
``fused.graph_kernels.causal``).  Each reads None where its input is
absent, as on the CPU or at a program that records none of it."""
from types import SimpleNamespace

import pytest

from portbench.harness.cell import Context, reader


def _span(name, t0, t1, tid=1, **attrs):
    return SimpleNamespace(name=name, t_start=t0, t_end=t1, dur=t1 - t0,
                           tid=tid, depth=0, attrs=attrs)


def _eval(t0, t1, gens, device_s=None, kind="fused", name="engine.eval",
          kinds=None):
    attrs = {"kind": kind, "generations": gens}
    if device_s is not None:
        attrs["device_s"] = device_s
    if kinds is not None:
        attrs["density_kinds"] = kinds
    return _span(name, t0, t1, **attrs)


def _ctx(spans=(), untraced=(10.0, 12.0)):
    return Context(setup_s=3.0, window={"untraced": untraced},
                   spans=list(spans))


def test_causal_graph_ms_per_gen_reads_only_causal_programs():
    read = reader("causal_graph_ms_per_gen")
    spans = [_eval(0.0, 0.03, 4, device_s=0.024,
                   kinds=("causal", "dense")),
             _eval(0.1, 0.12, 2, device_s=0.010, kinds=["causal"]),
             # programs without a causal tensor, one recording no kinds
             # (the parent's), a first sighting and a span without a
             # device clock count for nothing
             _eval(0.2, 0.3, 4, device_s=0.5, kinds=("dense",
                                                     "structured")),
             _eval(0.3, 0.4, 4, device_s=0.5),
             _eval(0.4, 0.5, 4, device_s=0.5, name="engine.compile",
                   kinds=("causal",)),
             _eval(0.5, 0.6, 4, kinds=("causal",))]
    assert read(_ctx(spans)) == pytest.approx(34.0 / 6)
    assert read(_ctx(spans[2:])) is None
    assert read(_ctx()) is None


def test_causal_graph_kernels_is_the_mean_of_the_causal_captures(
        monkeypatch):
    from repro_torch.obs import metrics
    monkeypatch.setattr(metrics, "REGISTRY", metrics.Registry())
    read = reader("causal_graph_kernels")
    assert read(_ctx()) is None
    metrics.histogram("fused.graph_kernels.causal")  # made, never observed
    metrics.histogram("fused.graph_kernels").observe(2509)  # no causal one
    assert read(_ctx()) is None
    for n in (3600, 3620):
        metrics.histogram("fused.graph_kernels.causal").observe(n)
    assert read(_ctx()) == pytest.approx(3610.0)
