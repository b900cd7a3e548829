"""Host ms a call inside ``sr.bins`` (the bin build's launches from the
host), over the traced ``render(rp)`` calls (layer: bins). Nothing
where the program has no spans."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchlib import spans  # noqa: E402


def read(ctx):
    return spans.per_item(ctx, "sr.bins", 2)
