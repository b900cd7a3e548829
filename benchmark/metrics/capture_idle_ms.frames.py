"""Device idle ms a frame inside ``sr.frame_graph.capture`` (a key's
first frame, rendered eagerly, and its capture): the idle gaps between
device operations whose middle lies inside the span on its thread,
over the traced call's frames (layer: compiled frame). Nothing where
the program has no spans."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import spans  # noqa: E402


def read(ctx):
    return spans.per_item(ctx, "sr.frame_graph.capture", 1)
