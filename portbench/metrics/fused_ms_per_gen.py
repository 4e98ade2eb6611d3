"""Milliseconds per generation of the fused search's chunks
(``search.chunk`` spans: graph replays, the one device-to-host copy and
the host's fold of the chunk)."""


def read(ctx):
    chunks = [s for s in ctx.spans if s.name == "search.chunk"]
    gens = sum(s.attrs.get("length", 0) for s in chunks)
    if not gens:
        return None
    return sum(s.dur for s in chunks) * 1000.0 / gens
