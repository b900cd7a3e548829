"""Device ms a frame of the bin build: operations launched with
ops/binning.py as the innermost frame of the program on the host,
without the named kernels launched from there (K2's walk, K3's merge,
K4's resolve), in the frames rendered eagerly with Python stacks
(layer: bins). Nothing without Python stacks in the trace."""

import re

NAMED = re.compile(r"walk_kernel|span_kernel|super_kernel|"
                   r"visibility_kernel|resolve_merge_kernel")


def _bins(name, module):
    return (module is not None and module.startswith("ops/binning.py:")
            and not NAMED.search(name))


def read(ctx):
    s = ctx.stack
    if s is None:
        return None
    ms = s.attributed_ms(_bins)
    return None if ms is None else ms / s.items
