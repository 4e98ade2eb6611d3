"""Share of the untraced part of the window (host clock) in which the
device ran no fused graph: 1 - the summed ``device_s`` of the
``engine.eval`` spans of kind ``fused`` over the part's length.  What
the graph leaves idle: the host's work between chunks and searches, and
the chunks' copies in and out.  Absent where the program records no
``device_s``."""


def read(ctx):
    device_s = [s.attrs["device_s"] for s in ctx.spans
                if s.name == "engine.eval" and s.attrs.get("kind") == "fused"
                and "device_s" in s.attrs]
    a, b = ctx.window.get("untraced", (0.0, 0.0))
    if not device_s or b <= a:
        return None
    return 1.0 - sum(device_s) / (b - a)
