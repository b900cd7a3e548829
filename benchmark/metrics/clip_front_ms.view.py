"""Device ms a frame of the clip front-end: operations whose launch
has ops/clip.py, ops/setup.py or render.py's ``clip_front`` as the
innermost frame of the program on the host, in the frames rendered
eagerly under ``torch.profiler(with_stack=True)`` (layer: clip
front-end). Nothing without Python stacks in the trace."""

MODULES = ("ops/clip.py:", "ops/setup.py:")


def _clip_front(name, module):
    return module is not None and (module.startswith(MODULES)
                                   or module == "render.py:clip_front")


def read(ctx):
    s = ctx.stack
    if s is None:
        return None
    ms = s.attributed_ms(_clip_front)
    return None if ms is None else ms / s.items
