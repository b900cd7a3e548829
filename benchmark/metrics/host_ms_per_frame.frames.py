"""Host ms a frame inside ``render_batch``: the benchmark's host clock
around each call up to its return (before the harness waits for the
device), summed over the window and divided by its frames (layer:
compiled frame, parallel/batch.py and parallel/frame_graph.py)."""


def read(ctx):
    d = ctx.driver
    return sum(d.host_s) / d.items_done * 1e3 if d.items_done else None
