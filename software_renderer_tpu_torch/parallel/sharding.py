"""The appearance-training step: fit texture texels so that rendered
frames match target images.

Counterpart of the JAX package's ``texture_train_step``
(software_renderer_tpu/parallel/sharding.py:138-185). JAX shards the
batch over a (frames, rows) mesh with ``shard_map`` and sums the loss and
gradient with ``psum``; on one device that mesh is 1 x 1, the psums are
the identity, and the step below is what remains. A mesh over several
cards is not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.texture import Texture
from ..render import RenderPass, render


def texture_train_step(tex_data, rp: RenderPass, transforms, targets,
                       lr: float = 0.5, backend: str = "auto"):
    """One SGD step on the texels ``tex_data`` [Th, Tw, C].

    Renders ``rp`` (shading ``textured``) under each of ``transforms``
    [B, 4, 4] with the texture ``Texture(data=tex)`` (default filter and
    wrap, as JAX builds it; its quad table is rebuilt from the
    differentiable texels), takes the loss sum((color - target)^2) /
    (B * H * W * 4) against ``targets`` [B, H, W, 4], and returns
    (tex_data - lr * grad, loss), both detached.

    ``auto`` differentiates through the fused path: texture gradients
    flow through the texture tail (K7's gradient under SR_TEX_WINDOWED
    "1"), while the geometry region stops the rest without a warning,
    since only the texels are differentiated. Gradients are taken one
    frame at a time and summed (the texture is rebuilt per frame), so the
    graph of one frame is alive at a time.
    """
    tex = tex_data.detach().to(torch.float32).requires_grad_(True)
    b = transforms.shape[0]
    denom = b * rp.height * rp.width * 4
    loss = torch.zeros((), dtype=torch.float32, device=tex.device)
    grad = torch.zeros_like(tex)
    for t, target in zip(transforms.to(torch.float32), targets):
        with torch.enable_grad():
            frame = dataclasses.replace(rp, transform=t,
                                        texture=Texture(data=tex))
            color = render(frame, backend=backend).color
            err = color - target
            frame_loss = torch.sum(err * err)
            g, = torch.autograd.grad(frame_loss, tex)
        loss += frame_loss.detach()
        grad += g
    loss = loss / denom
    grad = grad / denom
    return (tex - lr * grad).detach(), loss
