"""Host ms a frame inside ``render``: the benchmark's host clock from the
call into ``render(rp)`` to its return, summed over the window's frames
and divided by their count (layer: entry, render.py)."""


def read(ctx):
    d = ctx.driver
    return sum(d.host_s) / len(d.host_s) * 1e3 if d.host_s else None
