"""K2's share of its roofline: its least time over its device time, in
the frames rendered eagerly with stacks (K2 by kernel name: the shading
instance of the bin walk, ``walk_kernel<true, ...>``).

Least time per frame: the larger of the bytes at the card's bandwidth
and the float32 operations at its peak, and never under the launch
floor (benchlib/peaks.py). Counted from what the frame needs, as the
benchmark's reference finds it (``ctx.work``):

* bytes: the stream-table row of each triangle that covers a pixel
  centre, read once (11 + 3A float32: edges, |D|, depth plane, id, and
  three plane coefficients per attribute channel), and K2's outputs for
  the covered pixels, written once (depth, id and the epilogue's output
  channels, float32 each);
* operations: 14 a covering (pixel, triangle) pair (two edge functions,
  the third from |D|, the depth plane) and 64 a covered pixel (the
  channels' planes, the normal's normalisation, two dot products, the
  specular power and the lit color).
"""

import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import peaks  # noqa: E402

K2 = re.compile(r"walk_kernel<true")
OPS_PER_PAIR = 14
OPS_PER_PIXEL = 64


def channels(cfg):
    """(attribute channels in the stream table, K2's output channels) of
    the configuration's shading, with the colours every scene has:
    rgb, the normal where it is lit, uv where it is textured (and 1/w
    with perspective-correct attributes); the base or lit rgb, the
    specular where a texture follows the light, and uv."""
    shading, lit = cfg["shading"], cfg.get("light") is not None
    if shading == "flat":
        return 0, 3
    attrs = 3 + 3 * (lit and shading in ("phong", "textured"))
    outs = 3
    if shading == "textured":
        attrs += 2
        outs += 2 + int(lit)
    if attrs and cfg["perspective_correct"]:
        attrs += 1
    return attrs, outs


def read(ctx):
    s = ctx.stack
    if s is None or not ctx.work:
        return None
    k2_s = sum(d for name, _, d, _ in s.device if K2.search(name)) / 1e6
    if k2_s <= 0:
        return None
    a, outs = channels(ctx.config)
    least = sum(peaks.least_s(
        w["triangles"] * (11 + 3 * a) * 4 + w["pixels"] * (8 + 4 * outs),
        OPS_PER_PAIR * w["pairs"] + OPS_PER_PIXEL * w["pixels"])
        for w in ctx.work)
    return least / k2_s * 100.0
