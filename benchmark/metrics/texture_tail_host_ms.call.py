"""Host ms a call inside ``sr.texture_tail`` (the texture tail's
launches from the host), over the traced ``render(rp)`` calls (layer:
texture tail). Nothing where the program has no spans."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import spans  # noqa: E402


def read(ctx):
    return spans.per_item(ctx, "sr.texture_tail", 2)
