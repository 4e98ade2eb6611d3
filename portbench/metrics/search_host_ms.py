"""Milliseconds of a search spent outside its chunks: for each
``search.run`` span of the untraced part of the window, its length less
the lengths of the ``search.chunk`` spans inside it, averaged over the
searches.  The strategy, encoding, evaluator, program lookup and initial
carry before the chunks, and the scalar-oracle walk after them."""


def read(ctx):
    runs = [s for s in ctx.spans if s.name == "search.run"]
    if not runs:
        return None
    chunks = [s for s in ctx.spans if s.name == "search.chunk"]
    host = [r.dur - sum(c.dur for c in chunks if c.tid == r.tid
                        and r.t_start <= c.t_start and c.t_end <= r.t_end)
            for r in runs]
    return sum(host) * 1000.0 / len(host)
