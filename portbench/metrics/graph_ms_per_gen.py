"""Device milliseconds a generation of the fused search's graph in the
untraced part of the window: the ``device_s`` of the ``engine.eval``
spans of kind ``fused`` (two CUDA events around a chunk's replays, on
the device's own clock, with no profiler running) over their
``generations``.  Absent where the program records no ``device_s``."""


def read(ctx):
    spans = [s for s in ctx.spans if s.name == "engine.eval"
             and s.attrs.get("kind") == "fused" and "device_s" in s.attrs]
    gens = sum(s.attrs.get("generations", 0) for s in spans)
    if not gens:
        return None
    return sum(s.attrs["device_s"] for s in spans) * 1000.0 / gens
