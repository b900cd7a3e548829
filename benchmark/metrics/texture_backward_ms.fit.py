"""Device ms a step of the backward pass: operations launched inside
autograd's ``autograd::engine::evaluate_function`` host operators, in
the traced training steps (layer: texture tail, training)."""


def read(ctx):
    t = ctx.trace
    if not t.items:
        return None
    return t.under_cpu_op("autograd::engine::evaluate_function") / t.items
