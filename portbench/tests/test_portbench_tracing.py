"""The readers of the program's own measurement of the fused search, on
synthetic spans: ``graph_ms_per_gen``, ``search_host_ms``,
``graph_idle_share`` (the ``engine.eval`` spans' ``device_s`` and the
``search.*`` spans of the untraced part) and ``graph_kernels`` (the
always-on histogram ``fused.graph_kernels``).  Each reads None where
its input is absent, as on the CPU or at a program that records none of
it."""
from types import SimpleNamespace

import pytest

from portbench.harness.cell import Context, reader


def _span(name, t0, t1, tid=1, **attrs):
    return SimpleNamespace(name=name, t_start=t0, t_end=t1, dur=t1 - t0,
                           tid=tid, depth=0, attrs=attrs)


def _eval(t0, t1, gens, device_s=None, kind="fused", name="engine.eval"):
    attrs = {"kind": kind, "generations": gens}
    if device_s is not None:
        attrs["device_s"] = device_s
    return _span(name, t0, t1, **attrs)


def _ctx(spans=(), untraced=(10.0, 12.0)):
    return Context(setup_s=3.0, window={"untraced": untraced},
                   spans=list(spans))


def test_graph_ms_per_gen_is_device_time_over_generations():
    read = reader("graph_ms_per_gen")
    spans = [_eval(0.0, 0.03, 4, device_s=0.021),
             _eval(0.1, 0.12, 2, device_s=0.010),
             # another program's evaluation, a first sighting, and a
             # span without a device clock count for nothing
             _eval(0.2, 0.3, 4, device_s=0.5, kind="bucket"),
             _eval(0.3, 0.4, 4, device_s=0.5, name="engine.compile"),
             _eval(0.4, 0.5, 4)]
    assert read(_ctx(spans)) == pytest.approx(31.0 / 6)
    assert read(_ctx(spans[2:])) is None
    assert read(_ctx()) is None


def test_search_host_ms_subtracts_only_its_own_chunks():
    read = reader("search_host_ms")
    spans = [_span("search.run", 0.0, 0.100),
             _span("search.chunk", 0.010, 0.040),
             _span("search.chunk", 0.040, 0.090),
             _span("search.run", 0.200, 0.260),
             _span("search.chunk", 0.210, 0.250),
             # outside every search, and inside one but on another thread
             _span("search.chunk", 0.150, 0.190),
             _span("search.chunk", 0.220, 0.230, tid=2)]
    # (100 - 80) and (60 - 40) ms
    assert read(_ctx(spans)) == pytest.approx(20.0)
    assert read(_ctx(spans[:3])) == pytest.approx(20.0)
    assert read(_ctx([_span("search.run", 0.0, 0.05)])) == \
        pytest.approx(50.0)
    assert read(_ctx(spans[1:3])) is None


def test_graph_idle_share_is_the_untraced_part_without_the_graph():
    read = reader("graph_idle_share")
    spans = [_eval(10.1, 10.2, 4, device_s=0.5),
             _eval(11.0, 11.5, 4, device_s=0.7),
             _eval(11.6, 11.7, 4, device_s=0.3, kind="bucket")]
    assert read(_ctx(spans)) == pytest.approx(1.0 - 1.2 / 2.0)
    assert read(_ctx([_eval(10.1, 10.2, 4)])) is None
    assert read(_ctx(spans, untraced=(5.0, 5.0))) is None
    assert read(Context(setup_s=1.0, window={}, spans=spans)) is None


def test_graph_kernels_is_the_mean_of_the_captures(monkeypatch):
    from repro_torch.obs import metrics
    monkeypatch.setattr(metrics, "REGISTRY", metrics.Registry())
    read = reader("graph_kernels")
    assert read(_ctx()) is None
    metrics.histogram("fused.graph_kernels")        # made, never observed
    assert read(_ctx()) is None
    for n in (3600, 3620):
        metrics.histogram("fused.graph_kernels").observe(n)
    assert read(_ctx()) == pytest.approx(3610.0)
