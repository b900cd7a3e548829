"""K7's share of its roofline: its least time over its device time, in
the traced call's replayed frames (by kernel name: ``sampler_kernel``,
csrc/sampler.cu; layer: texture tail).

Least time per frame: the bytes at the card's bandwidth, never under
the launch floor (benchlib/peaks.py); K7 only moves and lerps, so its
operations are not counted. Counted from what the frame needs, as the
benchmark finds it: the segments' windows come from the frozen copy of
the program's window rule (benchlib/windows.py) on the reference's uv
planes and covered pixels (``windows.work``):

* ``y0`` and ``nwin`` (int32) of every 1 x 128 segment;
* ``dy`` (int32) of each lane of a segment with a window (the kernel
  tests every lane of such a segment against its windows);
* ``xa``, ``fx`` and ``fy`` (4 bytes each) of each covered lane: each
  lies inside its segment's windows and samples;
* the texture's C channel planes with their 16 wrap-padded rows, once,
  where any lane samples;
* the C float32 output planes of the whole frame, written once.

A frame with no window needs the output's zeros and the segments'
counts alone.
"""

import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import peaks, windows  # noqa: E402

KERNEL = re.compile(r"\bsampler_kernel\b")


def least_s(work: dict) -> float:
    """The least time of K7 on one frame (``windows.work``)."""
    lanes = windows.LANES
    table = (work["c"] * (work["th"] + windows.WINH) * work["tw"] * 4
             if work["windows"] else 0)
    n_bytes = (work["segments"] * 8 + work["window_segments"] * lanes * 4
               + work["lanes"] * 12 + table
               + work["c"] * work["segments"] * lanes * 4)
    return peaks.least_s(n_bytes, 0)


def read(ctx):
    drv, t = ctx.driver, ctx.trace
    if t is None or not hasattr(drv, "_frames"):
        return None
    busy_s = sum(d for name, _, d, _ in t.device if KERNEL.search(name)) / 1e6
    if busy_s <= 0:
        return None
    _, ts = drv._frames(drv.start + drv.attempted)   # trace_fn's call
    scene = drv.reference_scene()
    least = sum(least_s(windows.work(scene, t, ctx.config)) for t in ts)
    return least / busy_s * 100.0
