"""Device operations a frame (kernels, copies and memsets) in the
traced stretch of ``render(rp)`` calls (layer: entry, render.py)."""


def read(ctx):
    t = ctx.trace
    return t.launches() / t.items if t.items else None
