"""Device ms a frame of the texture tail: operations launched with
ops/texture.py, ops/texture_kernel.py or ops/shading.py as the
innermost frame of the program on the host, and the windowed sampler
(K7, ``sampler_kernel``) by name, in the frames rendered eagerly with
Python stacks (layer: texture tail). Nothing without Python stacks."""

MODULES = ("ops/texture.py:", "ops/texture_kernel.py:", "ops/shading.py:")


def _tail(name, module):
    return "sampler_kernel" in name or (module is not None
                                        and module.startswith(MODULES))


def read(ctx):
    s = ctx.stack
    if s is None:
        return None
    ms = s.attributed_ms(_tail)
    return None if ms is None else ms / s.items
