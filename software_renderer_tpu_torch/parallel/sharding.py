"""Rendering over a (frames, rows) grid of devices, and the
appearance-training step.

Counterpart of the JAX package's parallel/sharding.py, where
``shard_map`` runs one program per device of a ``jax.sharding.Mesh``:

* **frames**: independent frames split across the first axis, the scene
  replicated (here: copied to each device with ``RenderPass.to``).
* **rows**: each frame split by screen rows across the second axis;
  every device renders all triangles into its own band of rows
  (``render_rows``, an exact viewport shift).
* **shard_frontend**: the per-triangle front-end split across the rows
  axis, each row shard launching the front-end kernel over
  ``ceil(T / n_rows)`` triangles (setup and stream table), then gathered
  so every band reads the whole front (JAX's ``all_gather``; here a
  concatenation on each device).

One host thread drives the mesh's devices, frames one at a time (JAX
scans them) and bands one after another. ``render_rows`` makes no host
sync, so the thread queues a band's launches on its device and moves on
to the next band; whether bands on different cards then overlap is not
measured, and the port has no thread or stream per device. A device may appear more than once in a mesh: the
counterpart of XLA's virtual host devices, so a mesh of any shape runs
on one card or on the CPU. The training step sums the per-shard losses
and gradients where JAX ``psum``s them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..device import default_device
from ..framebuffer import Framebuffer
from ..ops import frontend as fe
from ..ops.texture import Texture
from ..render import RenderPass, planar_front_table_of, render_rows


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """A (frames, rows) grid of torch devices: ``devices[f][r]`` renders
    frame shard f's band r (JAX's ``Mesh`` with axes ("frames", "rows"))."""

    devices: tuple  # n_frames tuples of n_rows torch.device

    @property
    def shape(self) -> dict:
        return {"frames": len(self.devices), "rows": len(self.devices[0])}


def make_mesh(n_frames: int, n_rows: int, devices=None) -> DeviceMesh:
    """A (frames, rows) device mesh; ``n_frames * n_rows`` must equal the
    number of devices, by default every CUDA device (raises without a
    card: pass devices, e.g. ``["cpu"] * 4``)."""
    if devices is None:
        default_device()
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    assert n_frames * n_rows == len(devices), (
        f"mesh {n_frames}x{n_rows} != {len(devices)} devices")
    return DeviceMesh(tuple(tuple(devices[f * n_rows:(f + 1) * n_rows])
                            for f in range(n_frames)))


def _replicas(rp: RenderPass, mesh: DeviceMesh) -> dict:
    """{device: the scene on it}, one copy per distinct device."""
    return {d: rp.to(d) for row in mesh.devices for d in row}


def _splits_frontend(rp: RenderPass, mesh: DeviceMesh,
                     shard_frontend: bool) -> bool:
    """JAX's condition for the split front-end: asked for, more than one
    row shard, triangles, no near-plane clip."""
    return (shard_frontend and mesh.shape["rows"] > 1 and not rp.clip_near
            and rp.primitive == "triangle")


def sharded_front(scene_on, transform, row_devices) -> dict:
    """The planar front-end split across ``row_devices``: row shard r
    launches the main path's front-end (:func:`render.
    planar_front_table_of`: the setup and the stream table in one K1
    launch) over triangles [r * tloc, (r + 1) * tloc), tloc =
    ceil(T / n), on its device (``scene_on(dev)`` is the RenderPass
    there), the corners zero-padded to ``tloc * n`` triangles as JAX
    pads them (a zero triangle is degenerate, never valid). Returns
    {device: (PlanarSetup, (table, n_channels, poison))}, the gathered
    setup and stream table of all ``tloc * n`` triangles on it; K1 is
    per-triangle, so their first T rows equal the unsplit front-end's."""
    n = len(row_devices)
    names = [f.name for f in dataclasses.fields(fe.PlanarSetup)]
    parts = []
    for r, dev in enumerate(row_devices):
        rp = dataclasses.replace(scene_on(dev), transform=transform.to(dev))
        tloc = -(-rp.mesh.triangles().shape[0] // n)
        parts.append(planar_front_table_of(rp, r * tloc, tloc))
    _, (_, n_chans, poison) = parts[0]
    return {dev: (fe.PlanarSetup(**{k: torch.cat([getattr(ps, k).to(dev)
                                                  for ps, _ in parts])
                                    for k in names}),
                  (torch.cat([tab[0].to(dev) for _, tab in parts]),
                   n_chans, poison.to(dev)))
            for dev in dict.fromkeys(row_devices)}


def _bands(rp: RenderPass, mesh: DeviceMesh, b: int):
    """(frame index, [(device, y0, rows) of each of its bands]) for every
    frame of a B-frame batch, frame shard by frame shard."""
    n_frames, n_rows = mesh.shape["frames"], mesh.shape["rows"]
    assert rp.height % n_rows == 0, "height must divide over the rows axis"
    assert b % n_frames == 0, "the batch must divide over the frames axis"
    rows, per = rp.height // n_rows, b // n_frames
    for f, row_devices in enumerate(mesh.devices):
        for i in range(f * per, (f + 1) * per):
            yield i, [(dev, r * rows, rows)
                      for r, dev in enumerate(row_devices)]


def render_sharded(rp: RenderPass, transforms, mesh: DeviceMesh,
                   backend: str = "auto",
                   shard_frontend: bool = True) -> Framebuffer:
    """Render [B] frames over a (frames, rows) mesh.

    transforms: [B, 4, 4] array-like, B divisible by the mesh's frames;
    rp.height divisible by its rows. Each frame is rendered as
    ``render_rows`` bands, band r on device ``devices[f][r]`` of its
    frame shard f. Returns color [B, H, W, 4] and depth [B, H, W] on the
    mesh's first device.

    shard_frontend (default on): split the front-end across the rows axis
    and gather it (:func:`sharded_front`) instead of recomputing it per
    band; ignored for ``clip_near`` scenes and a single row shard.

    One host thread drives the mesh's devices (see the module
    docstring).
    """
    out_dev = mesh.devices[0][0]
    ts = torch.as_tensor(transforms, dtype=torch.float32, device=out_dev)
    on = _replicas(rp, mesh)
    split = _splits_frontend(rp, mesh, shard_frontend)
    color = torch.empty((ts.shape[0], rp.height, rp.width, 4),
                        dtype=torch.float32, device=out_dev)
    depth = torch.empty((ts.shape[0], rp.height, rp.width),
                        dtype=torch.float32, device=out_dev)
    for i, bands in _bands(rp, mesh, ts.shape[0]):
        fronts = (sharded_front(on.get, ts[i], [d for d, _, _ in bands])
                  if split else {})
        for dev, y0, rows in bands:
            front, table = fronts.get(dev, (None, None))
            fb = render_rows(
                dataclasses.replace(on[dev], transform=ts[i].to(dev)),
                y0, rows, backend=backend, front=front, table=table)
            color[i, y0:y0 + rows] = fb.color
            depth[i, y0:y0 + rows] = fb.depth
    return Framebuffer(color=color, depth=depth)


def texture_train_step(tex_data, rp: RenderPass, transforms, targets,
                       mesh: Optional[DeviceMesh] = None, lr: float = 0.5,
                       backend: str = "auto"):
    """One SGD step on the texels ``tex_data`` [Th, Tw, C] over a
    (frames, rows) mesh (JAX's argument order).

    Renders ``rp`` (shading ``textured``) under each of ``transforms``
    [B, 4, 4] with the texture ``Texture(data=tex)`` (default filter and
    wrap, as JAX builds it), band by band over ``mesh`` with the split
    front-end, as :func:`render_sharded` does; ``mesh=None`` is a 1 x 1
    mesh on the texture's device. The loss is sum((color - target)^2) /
    (B * H * W * 4) against ``targets`` [B, H, W, 4]; each band's loss
    and texel gradient are taken on its device and summed on the
    texture's device (JAX's psum). Returns (tex_data - lr * grad, loss),
    both detached, on the texture's device.

    ``auto`` differentiates through the fused path: texture gradients
    flow through the texture tail (K7's gradient under SR_TEX_WINDOWED
    "1"), while the geometry region stops the rest without a warning,
    since only the texels are differentiated. One band's graph is alive
    at a time.
    """
    tex = tex_data.detach().to(torch.float32)
    if mesh is None:
        mesh = DeviceMesh(((tex.device,),))
    ts = torch.as_tensor(transforms, dtype=torch.float32, device=tex.device)
    denom = ts.shape[0] * rp.height * rp.width * 4
    on = _replicas(rp, mesh)
    split = _splits_frontend(rp, mesh, True)
    loss = torch.zeros((), dtype=torch.float32, device=tex.device)
    grad = torch.zeros_like(tex)
    for i, bands in _bands(rp, mesh, ts.shape[0]):
        fronts = (sharded_front(on.get, ts[i], [d for d, _, _ in bands])
                  if split else {})
        for dev, y0, rows in bands:
            front, table = fronts.get(dev, (None, None))
            tex_d = tex.to(dev).detach().requires_grad_(True)
            with torch.enable_grad():
                frame = dataclasses.replace(
                    on[dev], transform=ts[i].to(dev),
                    texture=Texture(data=tex_d))
                color = render_rows(frame, y0, rows, backend=backend,
                                    front=front, table=table).color
                err = color - targets[i, y0:y0 + rows].to(dev)
                band_loss = torch.sum(err * err)
                g, = torch.autograd.grad(band_loss, tex_d)
            loss += band_loss.detach().to(tex.device)
            grad += g.to(tex.device)
    loss = loss / denom
    grad = grad / denom
    return (tex - lr * grad).detach(), loss
