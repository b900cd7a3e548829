"""K2's share of its roofline in the frames rendered eagerly with
stacks, the arithmetic of ``raster_roofline_pct.frames`` (loaded from
its file, not copied) at this cell's shading: untextured Phong, K2's
plan without the texture's channels (layer: raster and shade)."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import plugins  # noqa: E402


def read(ctx):
    return plugins.load("metrics", "raster_roofline_pct.frames").read(ctx)
