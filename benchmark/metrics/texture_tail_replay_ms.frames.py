"""Device ms a replayed frame of the texture tail (``sr.texture_tail``:
the texture sample and combine): the replay's device operations cut by
the layer map in its span's name, over the traced call's replays
(layer: texture tail). Nothing where the program has no spans or a
replay does not match its map."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import spans  # noqa: E402


def read(ctx):
    return spans.replay_ms(ctx, "texture_tail")
