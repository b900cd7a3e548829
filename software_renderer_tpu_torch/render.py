"""RenderPass and the render orchestrator (triangle path, all backends).

Every frame starts with the planar front-end (ops/frontend.py, CUDA
kernel on the card). Then, by backend:

* ``auto`` / ``binned`` (the main path): the banded bin build
  (ops/binning.py), the fused raster + shade kernel (with the overflow
  merge kernels on spill frames), then the texture sample and combine
  (ops/shading.py finish_fused). A shading plan with no attribute
  channels (``flat``, or phong without colors and light) takes
  ``binned_pipeline``'s visibility pass and ``shade_gbuffer`` instead.
* ``pallas``: the record-walking visibility kernel over every triangle
  (ops/rasterize_kernel.py), then the deferred ``shade``.
* ``reference``: the brute-force visibility pass in plain torch
  (ops/rasterize_ref.py), then ``shade``.

Every tensor follows the device of the RenderPass's tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .framebuffer import Framebuffer
from .models.mesh import Mesh
from .ops import frontend as fe
from .ops.binning import binned_pipeline, fused_pipeline
from .ops.rasterize_kernel import visibility_pallas
from .ops.rasterize_ref import visibility_ref
from .ops.shading import (Light, attribute_channels, finish_fused,
                          fused_output_channels, shade, shade_gbuffer,
                          shading_params)
from .ops.texture import Texture
from .ops.transforms import inverse_transpose_3x3


@dataclasses.dataclass
class RenderPass:
    """One draw: mesh + transform + options in, framebuffer out."""

    mesh: Mesh
    transform: torch.Tensor          # [4, 4] MVP (column vectors)
    width: int = 512
    height: int = 512
    primitive: str = "triangle"
    shading: str = "vertex"          # vertex | phong | textured (| flat)
    cull_backfaces: bool = False
    perspective_correct: bool = False
    clip_near: bool = False
    light: Optional[Light] = None
    texture: Optional[Texture] = None
    flat_color: torch.Tensor = dataclasses.field(
        default_factory=lambda: torch.ones(3, dtype=torch.float32))
    # Model matrix, used only to rotate normals into lighting space.
    model: Optional[torch.Tensor] = None

    def to(self, device) -> "RenderPass":
        mv = lambda a: None if a is None else a.to(device)
        return dataclasses.replace(
            self, mesh=self.mesh.to(device), transform=self.transform.to(
                device), light=mv(self.light), texture=mv(self.texture),
            flat_color=self.flat_color.to(device), model=mv(self.model))


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to PyTorch yet (ROADMAP.md {item})")


def _normal_matrix(rp: RenderPass):
    return None if rp.model is None else inverse_transpose_3x3(
        rp.model[:3, :3])


def planar_front_of(rp: RenderPass) -> fe.PlanarSetup:
    """The planar front-end of a triangle RenderPass."""
    tris = rp.mesh.triangles().long()
    return fe.planar_front(fe.corner_cols(rp.mesh.positions[tris]),
                           rp.transform, rp.width, rp.height,
                           cull_backfaces=rp.cull_backfaces)


def triangle_inputs(rp: RenderPass, ps: Optional[fe.PlanarSetup] = None):
    """What the fused pipeline takes for a triangle RenderPass: the planar
    front-end (computed unless given), the channel plan, the per-corner
    attribute columns (normals rotated by the model's normal matrix), the
    shading row, and whether the frame is lit and textured."""
    mesh = rp.mesh
    tris = mesh.triangles().long()
    if ps is None:
        ps = planar_front_of(rp)
    has_light = rp.light is not None and mesh.normals is not None
    has_texture = rp.shading == "textured"
    if has_texture and (mesh.uvs is None or rp.texture is None):
        raise ValueError("'textured' shading requires uvs + texture")
    chans = attribute_channels(rp.shading, mesh.colors is not None,
                               has_light)
    attrs = []
    for name, _ in chans:
        if name == "rgb":
            attrs += fe.attr_corner_cols(mesh.colors[tris])
        elif name == "uv":
            attrs += fe.attr_corner_cols(mesh.uvs[tris])
        elif name == "normal":
            nx, ny, nz = fe.attr_corner_cols(mesh.normals[tris])
            nm = _normal_matrix(rp)
            if nm is not None:
                rot = lambda i: tuple(
                    nm[i, 0] * nx[c] + nm[i, 1] * ny[c] + nm[i, 2] * nz[c]
                    for c in range(3))
                nx, ny, nz = rot(0), rot(1), rot(2)
            attrs += [nx, ny, nz]
    params = shading_params(rp.light, flat_color=rp.flat_color)
    return ps, chans, attrs, params, has_light, has_texture


def _visibility(setup, rp: RenderPass, backend: str, y_start: int = 0):
    """(depth, tri_id) of the ``reference`` or ``pallas`` visibility
    pass."""
    passes = {"reference": visibility_ref, "pallas": visibility_pallas}
    if backend not in passes:
        raise ValueError(f"unknown backend {backend!r}")
    return passes[backend](setup, width=rp.width, height=rp.height,
                           y_start=y_start)


def render_triangles(rp: RenderPass, backend: str = "auto") -> Framebuffer:
    """The planar, non-clipped triangle path on any backend (``auto`` is
    ``binned``, as in the JAX package)."""
    if backend not in ("auto", "binned", "pallas", "reference"):
        raise ValueError(f"unknown backend {backend!r}")
    if rp.clip_near:
        raise _not_ported("clip_near=True", "Queue 1 item 2, clip")
    if rp.perspective_correct:
        raise _not_ported("perspective_correct=True",
                          "Queue 1 item 3, perspective-correct attributes")
    mesh = rp.mesh
    ps = planar_front_of(rp)
    if backend in ("reference", "pallas"):
        setup = fe.to_setup(ps)
        depth, tri_id = _visibility(setup, rp, backend)
        color = shade(setup, tri_id, mesh.triangles().long(),
                      shading=rp.shading, colors=mesh.colors,
                      normals=mesh.normals, uvs=mesh.uvs, light=rp.light,
                      texture=rp.texture, flat_color=rp.flat_color,
                      normal_matrix=_normal_matrix(rp))
        return Framebuffer(color=color, depth=depth)
    ps, chans, attrs, params, has_light, has_texture = triangle_inputs(rp, ps)
    # The JAX package's budgets for the banded layout: culled scenes emit
    # about half the pairs, and bands emit ~1.3-1.5x more pairs than
    # whole tiles.
    budget = 0.85 if rp.cull_backfaces else 3.0
    if not chans:
        depth, tri_id, _ = binned_pipeline(
            ps, None, width=rp.width, height=rp.height,
            pair_budget_factor=budget)
        color = shade_gbuffer(None, tri_id != -1, shading=rp.shading,
                              chans=chans, light=rp.light, texture=rp.texture,
                              flat_color=rp.flat_color)
        return Framebuffer(color=color, depth=depth)
    out_chans = fused_output_channels(rp.shading, chans, has_light,
                                      has_texture)
    depth, tri_id, out = fused_pipeline(
        ps, attrs, params, width=rp.width, height=rp.height, chans=chans,
        has_light=has_light, has_texture=has_texture,
        pair_budget_factor=budget)
    color = finish_fused(out, tri_id != -1, out_chans=out_chans,
                         light=rp.light, texture=rp.texture)
    return Framebuffer(color=color, depth=depth)


def render(rp: RenderPass, backend: str = "auto") -> Framebuffer:
    """Render one frame of a triangle RenderPass."""
    if rp.transform.dim() != 2:
        raise _not_ported(
            f"a batch of transforms {tuple(rp.transform.shape)}",
            "Queue 1 item 9, batching")
    if rp.primitive == "triangle":
        return render_triangles(rp, backend)
    if rp.primitive in ("line", "point", "vertices"):
        raise _not_ported(f"primitive={rp.primitive!r}",
                          "Queue 1 item 4, lines and points")
    raise ValueError(f"unknown primitive {rp.primitive!r}")
