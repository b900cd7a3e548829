"""K2's share of its roofline in the teapot frames rendered eagerly
with stacks, the arithmetic of ``raster_roofline_pct.frames`` (loaded
from its file, not copied) at this cell's shading: untextured Phong,
unculled. The reference's counts (``ctx.work``) come from its setup
under the configuration's ``cull_backfaces``, so with culling off they
hold the back faces' rows, covering pairs and covered pixels, which
K2's unculled walk tests too (layer: raster and shade)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import plugins  # noqa: E402


def read(ctx):
    return plugins.load("metrics", "raster_roofline_pct.frames").read(ctx)
