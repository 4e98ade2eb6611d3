"""Mapping candidates the program scored in the window, over the
window's wall seconds (host clock; the window runs to the end of the
search in progress when its time is up)."""


def read(ctx):
    w = ctx.window
    if not w.get("candidates") or w["wall_s"] <= 0:
        return None
    return w["candidates"] / w["wall_s"]
