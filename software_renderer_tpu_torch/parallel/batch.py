"""Frame batching: one scene under a batch of transforms.

Counterpart of the JAX package's parallel/batch.py. JAX vmaps the
jitted frame function (``render_batch``) or scans groups of vmapped
frames (``render_batch_chunked``); on one card the port renders the
frames one after another in both, since a frame's kernels already fill
the card, and replays one captured frame for each
(parallel/frame_graph.py, the counterpart of the jit), kept across
calls as JAX keeps its compiled function.
"""

from __future__ import annotations

import dataclasses

import torch

from ..framebuffer import Framebuffer
from ..render import RenderPass
from .frame_graph import FrameGraph

# The captured frames of every render_batch call in the process.
_graph = FrameGraph()


def _transforms(rp: RenderPass, transforms) -> torch.Tensor:
    """Any array-like of [B, 4, 4] transforms as float32 on the device
    of ``rp``'s transform."""
    return torch.as_tensor(transforms, dtype=torch.float32,
                           device=rp.transform.device)


def render_batch(rp: RenderPass, transforms, backend: str = "auto"
                 ) -> Framebuffer:
    """Render B frames of ``rp`` under ``transforms`` [B, 4, 4] (a tensor,
    numpy array or nested list; ``rp``'s own transform is ignored).
    Returns color [B, H, W, 4] and depth [B, H, W].

    The frames render one after another into the preallocated outputs,
    so peak memory is the output plus one frame's intermediates (on the
    card, those of the captured frame). On the card the first frame of a
    pass renders eagerly and is captured, and every later one replays it,
    in this call and in later calls with the same pass
    (:class:`parallel.frame_graph.FrameGraph`, one for the process;
    eagerly where no graph can hold the frame). The capture outlives the
    call: it keeps ``rp``'s mesh, texture, light and model alive and its
    graph's memory reserved until a new capture finds it the least
    recently used of more than ``frame_graph.MAX_CAPTURES``."""
    ts = _transforms(rp, transforms)
    color = depth = None
    for i, t in enumerate(ts):
        fb = _graph(dataclasses.replace(rp, transform=t), backend=backend)
        if color is None:
            color = fb.color.new_empty((len(ts),) + tuple(fb.color.shape))
            depth = fb.depth.new_empty((len(ts),) + tuple(fb.depth.shape))
        color[i] = fb.color
        depth[i] = fb.depth
        del fb
    return Framebuffer(color=color, depth=depth)


def animation_transforms(scene_transform_fn, times):
    """[B] times -> [B, 4, 4]: ``scene_transform_fn`` at each time."""
    return torch.stack([scene_transform_fn(t) for t in
                        torch.as_tensor(times, dtype=torch.float32)])


def render_batch_chunked(rp: RenderPass, transforms,
                         backend: str = "binned",
                         vmap_chunk: int = 8) -> Framebuffer:
    """JAX's bounded-memory batch (groups of ``vmap_chunk`` vmapped
    frames, B a multiple of it): :func:`render_batch`, whose frames
    already render one at a time."""
    b = len(transforms)
    assert b % vmap_chunk == 0, (b, vmap_chunk)
    return render_batch(rp, transforms, backend)
