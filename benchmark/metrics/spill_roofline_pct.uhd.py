"""K3's and K4's share of their roofline: their least time over their
device time, in the traced call's replayed frames (by kernel name: K3's
``span_kernel``, ``super_kernel`` and ``visibility_kernel``, K4's
``resolve_merge_kernel``; layer: spill). The traced call sweeps the
whole orbit, as every call does; the four frames rendered eagerly with
stacks span 66 of its 704 frames and can all fall where nothing spills.

Least time per frame: the larger of the bytes at the card's bandwidth
and the float32 operations at its peak, and never under the launch
floor (benchlib/peaks.py). Counted from what the frame needs, as the
benchmark finds it: which triangles spill comes from the frozen copy of
the program's overflow rule (benchlib/overflow.py), and the reference
rasterizes those triangles alone (``overflow.work``):

* bytes: each spilled triangle's stream-table row (11 + 3A float32:
  edges, |D|, depth plane, id, and three plane coefficients per
  attribute channel) read once, and for each pixel the spilled
  triangles win among themselves its depth, id and A G-buffer channels
  (float32 each) written once;
* operations: 14 a covering (pixel centre, spilled triangle) pair (two
  edge functions, the third from |D|, the depth plane).

A is the configuration's attribute channels (``raster_roofline_pct
.frames``' ``channels``). A frame with nothing spilled needs the
launch floor.
"""

import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import overflow, peaks, plugins  # noqa: E402

KERNELS = re.compile(r"\b(span_kernel|super_kernel|visibility_kernel|"
                     r"resolve_merge_kernel)\b")
OPS_PER_PAIR = 14


def least_s(work: dict, channels: int) -> float:
    """The least time of one frame's overflow pass (``overflow.work``)
    with ``channels`` attribute channels."""
    n_bytes = (work["spilled"] * (11 + 3 * channels) * 4
               + work["pixels"] * (8 + 4 * channels))
    return peaks.least_s(n_bytes, OPS_PER_PAIR * work["pairs"])


def read(ctx):
    drv, t = ctx.driver, ctx.trace
    if t is None or not hasattr(drv, "_frames"):
        return None
    busy_s = sum(d for name, _, d, _ in t.device if KERNELS.search(name)) / 1e6
    if busy_s <= 0:
        return None
    _, ts = drv._frames(drv.start + drv.attempted)   # trace_fn's call
    scene = drv.reference_scene()
    a, _ = plugins.load("metrics", "raster_roofline_pct.frames").channels(
        ctx.config)
    least = sum(least_s(overflow.work(scene, t, ctx.config), a) for t in ts)
    return least / busy_s * 100.0
