"""Kernel nodes of the fused search's generation graph where the program
evaluates a causal_block_topk tensor (the program's always-on histogram
``fused.graph_kernels.causal_block_topk``, one observation a capture),
averaged over the captures.  Absent where the program observes none."""


def read(ctx):
    from repro_torch.obs import metrics
    h = metrics.snapshot().get("fused.graph_kernels.causal_block_topk")
    if not h or not h.get("count"):
        return None
    return h["mean"]
