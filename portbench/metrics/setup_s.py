"""Set-up seconds: process start (imports, CUDA's start) to the
window's start, through building the cell and warming every program,
graph and shape it uses."""


def read(ctx):
    return ctx.setup_s
