"""Share of the traced stretch of the cell's own traffic in which no
kernel, copy or memset ran on the device (one minus the union of the
device intervals over the stretch), in % (layer: device)."""


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0:
        return None
    return (1.0 - t.busy_s() / t.window_s) * 100.0
