"""Frame batching: one scene under a batch of transforms.

Counterpart of the JAX package's parallel/batch.py. JAX vmaps the frame
function; on one card the port loops over the frames and stacks their
framebuffers (a frame's kernels already fill the card). The chunked batch
(``render_batch_chunked``) is ROADMAP.md Queue 1 item 9.
"""

from __future__ import annotations

import dataclasses

import torch

from ..framebuffer import Framebuffer
from ..render import RenderPass, render


def render_batch(rp: RenderPass, transforms, backend: str = "auto"
                 ) -> Framebuffer:
    """Render B frames of ``rp`` under ``transforms`` [B, 4, 4] (``rp``'s
    own transform is ignored). Returns color [B, H, W, 4] and depth
    [B, H, W]."""
    fbs = [render(dataclasses.replace(rp, transform=t), backend=backend)
           for t in transforms.to(torch.float32)]
    return Framebuffer(color=torch.stack([fb.color for fb in fbs]),
                       depth=torch.stack([fb.depth for fb in fbs]))


def animation_transforms(scene_transform_fn, times):
    """[B] times -> [B, 4, 4]: ``scene_transform_fn`` at each time."""
    return torch.stack([scene_transform_fn(t) for t in
                        torch.as_tensor(times, dtype=torch.float32)])
