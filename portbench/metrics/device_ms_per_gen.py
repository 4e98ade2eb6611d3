"""Device milliseconds a generation in the traced part of the window:
the union of the device operations' intervals (torch.profiler) over the
generations the traced searches ran.  Kernel lengths, unlike the gaps
between them, are the device's own, so this reads the engine's device
work a generation with the profiler's overhead left out."""


def read(ctx):
    d = ctx.device
    gens = ctx.window.get("traced_generations", 0)
    if not d or d["busy_s"] <= 0 or not gens:
        return None
    return d["busy_s"] * 1000.0 / gens
