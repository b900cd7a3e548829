"""Device operations a frame (kernels, copies and memsets) in the
traced stretch of the viewer's FrameLoop frames, RGBA8 conversion and
copy to the host included (layer: entry, utils/display.py)."""


def read(ctx):
    t = ctx.trace
    return t.launches() / t.items if t.items else None
