"""Anti-aliasing by supersampling (SSAA).

Counterpart of the JAX package's ops/msaa.py: render the frame at
s x s its size and box-filter it down. Color is the mean over each
s x s block; depth is its minimum (the closest surface under the pixel).
The supersampled frame runs the same path as any other, so on the card
it goes through the same kernels at s x s the pixels.
"""

from __future__ import annotations

import dataclasses

from ..framebuffer import Framebuffer
from ..render import RenderPass, render


def downsample_box(color, factor: int):
    """[H*f, W*f, C] -> [H, W, C] box filter."""
    h, w, c = color.shape
    color = color.reshape(h // factor, factor, w // factor, factor, c)
    return color.mean(dim=(1, 3))


def render_msaa(rp: RenderPass, samples: int = 2,
                backend: str = "auto") -> Framebuffer:
    """Render with samples x samples supersampling."""
    if samples == 1:
        return render(rp, backend=backend)
    hi = dataclasses.replace(rp, width=rp.width * samples,
                             height=rp.height * samples)
    fb = render(hi, backend=backend)
    color = downsample_box(fb.color, samples)
    h, w = fb.depth.shape
    depth = fb.depth.reshape(h // samples, samples, w // samples,
                             samples).amin(dim=(1, 3))
    return Framebuffer(color=color, depth=depth)
