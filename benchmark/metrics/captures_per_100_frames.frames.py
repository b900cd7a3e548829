"""CUDA-graph captures per 100 frames of the window: the program's
counter ``parallel.frame_graph.routes["capture"]`` (reset when the
window opens) over the frames completed (layer: compiled frame)."""


def read(ctx):
    d = ctx.driver
    if not d.items_done or "capture" not in d.window_routes:
        return None
    return d.window_routes["capture"] / d.items_done * 100.0
