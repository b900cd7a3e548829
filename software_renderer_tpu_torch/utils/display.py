"""Frame loop: the headless display layer.

Counterpart of the JAX package's utils/display.py: advance time, build
the frame's RenderPass, render, sink. The sink of frame N-1 (PNG files
through the native runtime, or the live viewer of utils/present.py) runs
on the host while frame N renders: each sunk frame is converted to RGBA8
on its device and copied into one of two pinned host buffers without
blocking, and a CUDA event recorded after the copy is what the loop
waits for before it encodes the frame.

Given a ``transform_fn``, the loop replays one captured frame per
transform (parallel/frame_graph.py), as JAX runs its jitted ``render``;
``render`` makes no host sync either way, so the host queues frame N
while the device still renders frame N-1, and how much of the sink the
device hides is a measurement, not a given: the benchmark's viewer cells
read the device's idle time inside ``sr.frame_loop.frame``
(``frame_idle_ms.view``, ``frame_idle_ms.teapot``).
"""

from __future__ import annotations

import dataclasses
import os
import time as _time
from typing import Callable, Optional

import torch

from ..framebuffer import to_rgba8
from ..framebuffer import Framebuffer
from ..ops.msaa import render_msaa
from ..parallel.frame_graph import FrameGraph
from ..render import RenderPass, render
from .config import RenderConfig
from .device import block_on
from .log import get_logger
from .profiling import span

log = get_logger("display")


class FrameLoop:
    """Drives scene_fn(time) -> RenderPass through the renderer.

    scene_fn is called once to build the scene; per frame only the
    transform changes (through transform_fn(time)) when one is given,
    and the frames replay one captured frame (without supersampling;
    parallel/frame_graph.py), else scene_fn builds each frame, eagerly.
    The pass scene_fn built is taken as unchanged between frames: only
    the first frame builds the capture's key.
    """

    def __init__(self, scene_fn: Callable[[float], RenderPass],
                 transform_fn: Optional[Callable] = None,
                 config: Optional[RenderConfig] = None):
        self.config = config or RenderConfig()
        self.time = 0.0
        self._rp = scene_fn(0.0)
        self._transform_fn = transform_fn
        self._scene_fn = scene_fn
        self._pinned = [None, None]
        self._graph = FrameGraph()

    def frame(self):
        """Render one frame and advance time by the config's time step.
        The framebuffer is the caller's: a replayed frame is copied out
        of the graph's outputs. Spans: ``sr.frame_loop.frame`` around the
        frame, ``sr.frame_loop.copy_out`` around the copy."""
        with span("sr.frame_loop.frame"):
            if self._transform_fn is not None and self.config.msaa <= 1:
                # The same pass each frame, its transform apart: the graph
                # replays without building the pass's key again.
                fb = self._graph(self._rp, backend=self.config.backend,
                                 transform=self._transform_fn(self.time))
                with span("sr.frame_loop.copy_out"):
                    fb = Framebuffer(color=fb.color.clone(),
                                     depth=fb.depth.clone())
            else:
                if self._transform_fn is not None:
                    rp = dataclasses.replace(
                        self._rp, transform=self._transform_fn(self.time))
                else:
                    rp = self._scene_fn(self.time)
                if self.config.msaa > 1:
                    fb = render_msaa(rp, samples=self.config.msaa,
                                     backend=self.config.backend)
                else:
                    fb = render(rp, backend=self.config.backend)
            self.time += self.config.time_step
            return fb

    def _stage(self, index: int, color: torch.Tensor):
        """(host uint8 [H, W, 4], what to wait for before reading it): on
        the card, RGBA8 there and a copy into pinned buffer ``index % 2``
        that does not block, and the event recorded after it."""
        img = to_rgba8(color)
        if not img.is_cuda:
            return img, img
        buf = self._pinned[index % 2]
        if buf is None or buf.shape != img.shape:
            buf = torch.empty(img.shape, dtype=torch.uint8, pin_memory=True)
            self._pinned[index % 2] = buf
        buf.copy_(img, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(img.device))
        return buf, done

    def run(self, n_frames: int, out_dir: Optional[str] = None,
            writer=None, present=None) -> float:
        """Render n_frames; optionally write PNGs to ``out_dir`` (through
        ``writer(path, uint8 array)``, by default the native runtime's
        ``write_png``) and/or publish to a live present surface
        (utils/present.py PresentServer). Returns mean FPS, the last
        frame waited for. Wrap a call in ``utils.profiling.trace()`` for
        a timeline.
        """
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            if writer is None:
                from .. import runtime
                writer = runtime.write_png
        sinking = bool(out_dir) or present is not None
        pending = None  # (index, host image, done) of the frame to sink
        fb = None
        t0 = _time.perf_counter()
        for i in range(n_frames):
            fb = self.frame()
            if sinking:
                staged = (i, *self._stage(i, fb.color))
                if pending is not None:
                    self._sink(writer, out_dir, present, *pending)
                pending = staged
        if pending is not None:
            self._sink(writer, out_dir, present, *pending)
        elif fb is not None:
            block_on(fb.color)
        dt = _time.perf_counter() - t0
        fps = n_frames / dt
        log.info("rendered %d frames in %.3fs (%.1f FPS)", n_frames, dt, fps)
        return fps

    @staticmethod
    def _sink(writer, out_dir, present, index, img, done):
        block_on(done)
        if out_dir:
            writer(os.path.join(out_dir, f"frame_{index:05d}.png"),
                   img.numpy())
        if present is not None:
            present.present(img)
