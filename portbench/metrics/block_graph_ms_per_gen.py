"""Device milliseconds a generation of the fused search's graph, over the
programs that evaluate a causal_block_topk tensor: ``graph_ms_per_gen``
restricted to the ``engine.eval`` spans of kind ``fused`` whose
``density_kinds`` hold ``causal_block_topk``.  Absent where the program
records no ``device_s`` or no ``density_kinds``, or knows no such kind."""


def read(ctx):
    spans = [s for s in ctx.spans if s.name == "engine.eval"
             and s.attrs.get("kind") == "fused" and "device_s" in s.attrs
             and "causal_block_topk" in s.attrs.get("density_kinds", ())]
    gens = sum(s.attrs.get("generations", 0) for s in spans)
    if not gens:
        return None
    return sum(s.attrs["device_s"] for s in spans) * 1000.0 / gens
