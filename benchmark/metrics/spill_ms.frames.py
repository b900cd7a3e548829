"""Device ms a frame of the overflow pass, by kernel name, in the
traced stretch of replayed frames: K3's merge (``span_kernel``,
``super_kernel``, ``visibility_kernel``) and K4's resolve
(``resolve_merge_kernel``), which run on every frame and stop at the
device's overflow count (layer: spill). K2 is left out: its one launch
a frame is the raster walk, seeded or not."""

PATTERN = (r"\b(span_kernel|super_kernel|visibility_kernel|"
           r"resolve_merge_kernel)\b")


def read(ctx):
    t = ctx.trace
    return t.device_ms(PATTERN) / t.items if t.items else None
