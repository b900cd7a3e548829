"""Device ms a replayed frame of the clip front-end (``sr.clip_front``:
the shading inputs, the transform, near-plane clip and setup of the
clipped triangles and their stream table): the replay's device
operations cut by the layer map in its span's name, over the traced
frames' replays (layer: clip front-end). Nothing where the program has
no spans or a replay does not match its map."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import spans  # noqa: E402


def read(ctx):
    return spans.replay_ms(ctx, "clip_front")
