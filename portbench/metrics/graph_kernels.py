"""Kernel nodes of the fused search's generation graph, counted where
the graph is captured (the program's always-on histogram
``fused.graph_kernels``, one observation a capture), averaged over the
captures.  Absent where the program observes none."""


def read(ctx):
    from repro_torch.obs import metrics
    h = metrics.snapshot().get("fused.graph_kernels")
    if not h or not h.get("count"):
        return None
    return h["mean"]
