"""Device ms a replayed frame of the bin build (``sr.bins``: the bins,
the binned stream rows and the bbox table): the replay's device
operations cut by the layer map in its span's name, over the traced
call's replays (layer: bins). Nothing where the program has no spans or
a replay does not match its map."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import spans  # noqa: E402


def read(ctx):
    return spans.replay_ms(ctx, "bins")
