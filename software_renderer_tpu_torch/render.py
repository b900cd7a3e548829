"""RenderPass and the render orchestrator: triangles on every backend,
row bands of the triangle path (``render_rows``), and the line and point
primitives (ops/lines.py, a deterministic scatter of DDA samples or
vertices; no backend applies to them).

Every frame starts with a front-end: the planar one (ops/frontend.py,
CUDA kernel on the card), or with ``clip_near=True`` the clip front-end
(ops/clip.py): the transform and near-plane clip to [2T] triangles, the
divide, ``ndc_to_screen`` and ``triangle_setup_from_corners``. Then, by
backend:

* ``auto`` / ``binned`` (the main path): the front-end writes the stream
  table with the setup (``planar_front_table``; with the clip
  ``clip_front_table``, one launch of csrc/clip_front.cu on the card and
  its torch chain on the CPU), then the banded bin build
  (ops/binning.py), the fused raster + shade kernel (with the overflow
  merge kernels on spill frames), then the texture tail, sample and
  combine (ops/shading.py ``texture_tail``): on the card one launch of
  the tail kernel (csrc/tail.cu) on every frame that needs no gradient,
  untextured or bilinear on sampler route "0"; ``finish_fused``'s torch
  operations on the CPU, under a gradient (texture training), for
  trilinear and nearest filters and on routes "1" and "adaptive" (K7).
  A shading plan with no attribute
  channels (``flat``, or phong without colors and light) takes
  ``binned_pipeline``'s visibility pass and ``shade_gbuffer`` instead.
* ``pallas``: the record-walking visibility kernel over every triangle
  (ops/rasterize_kernel.py), then the deferred ``shade``.
* ``reference``: the brute-force visibility pass in plain torch
  (ops/rasterize_ref.py), then ``shade``.

With the clip, ``pallas`` and ``reference`` take ``clip_front``'s
TriangleSetup, in torch operations on the card too.

``perspective_correct=True`` interpolates attributes perspective-correct:
on ``auto``/``binned`` the stream table carries each channel over w and
a 1/w channel (the front-end kernels' flag; ``perspective_vertex_attrs``
in the clip's plain version) and the fused kernel
runs its perspective plan; ``reference``/``pallas`` pass the corners'
w to ``shade``.

Every tensor follows the device of the RenderPass's tensors. On the
card a triangle frame makes no host sync and copies nothing from the
host (ops/binning.py keeps every count on the device, host constants
come from ``device.constant``), except the ``"adaptive"`` sampler's one
predicate read; parallel/frame_graph.py captures such a frame into a
CUDA graph.

Gradients: on ``auto``/``binned`` the geometry stage (either front-end,
bins, fused kernel) sits in one autograd region whose backward warns and
returns zeros for the geometry, vertex-attribute and light inputs, as
JAX's ``_stop_geometry_grads`` does; texture gradients flow through the
texture tail outside it. ``reference``/``pallas`` stop gradients at depth
and triangle id only, as in JAX.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from .framebuffer import CLEAR_COLOR, CLEAR_DEPTH, Framebuffer
from .models.mesh import Mesh
from .ops import frontend as fe
from .ops import lines as lines_ops
from .ops.binning import binned_pipeline, fused_pipeline, stream_table_of
from .ops.clip import (clip_front, clip_front_table, clipped_channels,
                       compose_attrs)
from .ops.rasterize_kernel import visibility_pallas
from .ops.rasterize_ref import visibility_ref
from .ops.shading import (Light, attribute_channels, fused_output_channels,
                          gather_attribute_values, shade, shade_gbuffer,
                          shading_params, texture_tail)
from .ops.texture import Texture
from .ops.transforms import inverse_transpose_3x3
from .ops.vertex import vertex_stage
from .utils.profiling import span


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
    if ps is None:
        ps = planar_front_of(rp)
    return (ps, *shading_inputs(rp))


def shading_inputs(rp: RenderPass, with_attrs: bool = True, tris=None):
    """:func:`triangle_inputs` without the front-end: the attribute
    columns of the triangles ``tris`` ([T', 3] vertex indices, by default
    the mesh's), or None without ``with_attrs``."""
    mesh = rp.mesh
    if tris is None and with_attrs:
        tris = mesh.triangles().long()
    has_light = rp.light is not None and mesh.normals is not None
    has_texture = rp.shading == "textured"
    if has_texture and (mesh.uvs is None or rp.texture is None):
        raise ValueError("'textured' shading requires uvs + texture")
    chans = attribute_channels(rp.shading, mesh.colors is not None,
                               has_light)
    attrs = [] if with_attrs else None
    for name, _ in chans if with_attrs else ():
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
    # On the mesh's device: a RenderPass built on the card without a
    # flat_color keeps the dataclass default's CPU tensor.
    params = shading_params(rp.light, flat_color=rp.flat_color,
                            device=rp.mesh.positions.device)
    return chans, attrs, params, has_light, has_texture


# The stream table's triangle-id column (ops/frontend.py
# ``stream_table_planar``).
_TABLE_ID = 10


def planar_front_table_of(rp: RenderPass, start: int = 0,
                          count: Optional[int] = None):
    """The main path's front-end launch (:func:`ops.frontend.
    planar_front_table`, with the pass's attribute channels as
    :func:`render_triangles` plans them) over triangles
    [start, start + count) of a triangle RenderPass, all of them by
    default: (PlanarSetup, (table, n_channels, poison)).

    Triangles past the mesh are zeros (degenerate, so invalid: the
    poison row). The table's id column holds the mesh's triangle ids
    (``start`` plus the local index), so the slices of a split
    front-end concatenate into the whole front-end's setup and table
    (the kernel is per-triangle)."""
    tris = rp.mesh.triangles().long()
    count = tris.shape[0] - start if count is None else count
    assert start + count < 2 ** 24, "ids are exact float32 integers"
    tris = tris[start:start + count]
    chans, attrs, *_ = shading_inputs(rp, tris=tris)

    def pad(x):
        # x zero-padded to count rows.
        if x.shape[0] == count:
            return x
        return torch.nn.functional.pad(
            x, (0, 0) * (x.dim() - 1) + (0, count - x.shape[0]))

    corners = pad(rp.mesh.positions[tris])
    cols = [tuple(pad(c) for c in chan) for chan in attrs]
    ps, table, n_chans, poison = fe.planar_front_table(
        fe.corner_cols(corners), rp.transform, cols,
        rp.width, rp.height, cull_backfaces=rp.cull_backfaces,
        perspective=rp.perspective_correct and bool(chans))
    if start:
        ids = table[:, _TABLE_ID]
        table[:, _TABLE_ID] = torch.where(ids >= 0, ids + float(start), ids)
    return ps, (table, n_chans, poison)


_FUSED_GRAD_MSG = (
    "render(backend='auto'/'binned') is being differentiated w.r.t. "
    "geometry/vertex-attribute/light inputs, but the fused pipeline stops "
    "those gradients (they are returned as ZERO). Only texture gradients "
    "flow on the fast path; use backend='pallas' or 'reference' for "
    "vertex-attribute/light gradients.")


class _StopGeometryGrads(torch.autograd.Function):
    """``fn(*inputs)`` run without a graph; its backward warns with
    :data:`_FUSED_GRAD_MSG` and returns zeros for the floating inputs."""

    @staticmethod
    def forward(ctx, fn, *inputs):
        ctx.specs = [(x.shape, x.dtype, x.device) for x in inputs]
        outs = fn(*inputs)
        ctx.mark_non_differentiable(
            *(o for o in outs if not o.is_floating_point()))
        return outs

    @staticmethod
    def backward(ctx, *grads):
        warnings.warn(_FUSED_GRAD_MSG, stacklevel=2)
        return (None, *(torch.zeros(shape, dtype=dt, device=dev)
                         if dt.is_floating_point else None
                         for shape, dt, dev in ctx.specs))


def _stop_geometry_grads(fn, *inputs):
    """Run ``fn(*inputs)`` (tensors in, a tuple of tensors out) with the
    inputs' gradients stopped, and warn if they are asked for.

    Counterpart of JAX's ``_stop_geometry_grads`` (render.py:113-151).
    The CUDA kernels have no gradient and their plain versions would give
    real ones, so without this region the card cuts the graph silently
    while the CPU differentiates. JAX's region begins at the planar
    setup; here it begins at the corner columns and the transform,
    because the front-end kernel cuts the graph too. The backward runs
    only when a caller differentiates these inputs: autograd records the
    region only for inputs that require grad, and texture-only training
    asks for no gradient of them, so with no input that requires grad
    ``fn`` runs without a graph and without the region, which would
    record nothing. Forward-mode AD is not supported.
    """
    if not any(x.requires_grad for x in inputs):
        with torch.no_grad():
            return fn(*inputs)
    return _StopGeometryGrads.apply(fn, *inputs)


def clip_front_inputs(rp: RenderPass, chans=None):
    """The arguments of ops/clip.py ``clip_front_table`` (and its plain
    version) for a ``clip_near`` RenderPass on the main path, as (args,
    kwargs): the mesh's positions and indices, its vertex arrays in the
    order of the channel plan ``chans`` (the pass's by default), the
    normals marked for the model's normal matrix, the transform and the
    frame's size."""
    mesh = rp.mesh
    if chans is None:
        chans = attribute_channels(rp.shading, mesh.colors is not None,
                                   rp.light is not None
                                   and mesh.normals is not None)
    arrays = {"rgb": mesh.colors, "normal": mesh.normals, "uv": mesh.uvs}
    sources = [(arrays[name], name == "normal") for name, _ in chans]
    nm = _normal_matrix(rp) if any(rot for _, rot in sources) else None
    return ((mesh.positions, mesh.indices, sources, nm, rp.transform,
             rp.width, rp.height),
            dict(cull_backfaces=rp.cull_backfaces,
                 perspective=rp.perspective_correct and bool(chans)))


def _corner_values(attrs):
    """Per-corner channel columns -> [T, 3, A] values."""
    return torch.stack([torch.stack(cols, dim=1) for cols in attrs], dim=2)


def clip_inputs(rp: RenderPass):
    """What the fused pipeline takes for a ``clip_near`` RenderPass, as
    the binned path computes it: (TriangleSetup of the [2T] clipped
    triangles, their channel values (:func:`clipped_channels`, None
    without channels), the channel plan, the shading row, lit, textured).
    """
    chans, attrs, params, has_light, has_texture = shading_inputs(rp)
    setup, vals = clipped_channels(
        rp.mesh.positions[rp.mesh.triangles().long()], rp.transform,
        _corner_values(attrs) if chans else None, rp.width, rp.height,
        cull_backfaces=rp.cull_backfaces,
        perspective=rp.perspective_correct and bool(chans))
    return setup, vals, chans, params, has_light, has_texture


def _visibility(setup, width: int, rows: int, backend: str,
                y_start: int = 0):
    """(depth, tri_id) of rows [y_start, y_start + rows) from the
    ``reference`` or ``pallas`` visibility pass."""
    passes = {"reference": visibility_ref, "pallas": visibility_pallas}
    if backend not in passes:
        raise ValueError(f"unknown backend {backend!r}")
    return passes[backend](setup, width=width, height=rows,
                           y_start=y_start)


def _pad_cols(attrs, t: int):
    """Attribute columns zero-padded to ``t`` triangles (a precomputed
    front may be padded past the mesh; padding is invalid, so it is never
    drawn)."""
    return [tuple(torch.nn.functional.pad(c, (0, t - c.shape[0]))
                  for c in cols) for cols in attrs]


def render_triangles(rp: RenderPass, backend: str = "auto",
                     y_start: Optional[int] = None,
                     rows: Optional[int] = None,
                     front: Optional[fe.PlanarSetup] = None,
                     table=None) -> Framebuffer:
    """The triangle path on any backend (``auto`` is ``binned``, as in the
    JAX package), with or without the near-plane clip and
    perspective-correct attributes; optionally only the rows
    [y_start, y_start + rows).

    A row band keeps global coordinates: the front-end runs over the
    whole viewport, and the bins, visibility, shading and texture tail
    over the band's pixel centres, so a band makes the full frame's
    coverage decisions. Bands need not be a multiple of the 64-row tile.
    Trilinear texture levels come from differences inside the band, so
    a band's last row repeats its own edge and does not stitch bit for
    bit with the next band (as in the JAX package).

    ``front``: a precomputed :class:`ops.frontend.PlanarSetup` of the
    mesh's triangles (zero-padded past them allowed: padding is invalid)
    used instead of the front-end (the front-end kernel does not run).
    Requires ``clip_near=False``. ``table``: the (table, n_channels,
    poison) stream table written with ``front``
    (:func:`planar_front_table_of`), used by ``auto``/``binned``; without
    it the table is built from ``front`` in torch ops.
    """
    if backend not in ("auto", "binned", "pallas", "reference"):
        raise ValueError(f"unknown backend {backend!r}")
    if front is not None and rp.clip_near:
        raise ValueError("a precomputed front requires clip_near=False")
    if table is not None and front is None:
        raise ValueError("a stream table comes with its front")
    out_h = rp.height if rows is None else int(rows)
    y0 = 0 if y_start is None else int(y_start)
    mesh = rp.mesh
    if backend in ("reference", "pallas"):
        tris = mesh.triangles().long()
        corner_attrs = None
        if rp.clip_near:
            setup, bary, w_c = clip_front(
                mesh.positions[tris], rp.transform, rp.width, rp.height,
                cull_backfaces=rp.cull_backfaces)
            # shade's own gather would index the unclipped mesh.
            attrs, chans = gather_attribute_values(
                rp.shading, tris, colors=mesh.colors, normals=mesh.normals,
                uvs=mesh.uvs,
                has_light=rp.light is not None and mesh.normals is not None)
            if attrs is not None:
                corner_attrs = (compose_attrs(bary, attrs), chans)
        else:
            ps = front if front is not None else planar_front_of(rp)
            setup, w_c = fe.to_setup(ps), fe.corner_w(ps)
        depth, tri_id = _visibility(setup, rp.width, out_h, backend, y0)
        # The visibility buffer is discrete: gradients flow through the
        # shading, not the coverage (JAX render.py:404-405).
        depth, tri_id = depth.detach(), tri_id.detach()
        color = shade(setup, tri_id, tris, shading=rp.shading,
                      colors=mesh.colors, normals=mesh.normals, uvs=mesh.uvs,
                      light=rp.light, texture=rp.texture,
                      flat_color=rp.flat_color,
                      normal_matrix=_normal_matrix(rp), y_start=y0,
                      w_tri=w_c if rp.perspective_correct else None,
                      corner_attrs=corner_attrs)
        return Framebuffer(color=color, depth=depth)
    # The layer spans (utils/profiling.py) partition the main path: the
    # front-end (the clip front-end with clip_near) gathers the inputs
    # here and runs inside ``geometry``, then the pipeline's bins, spill
    # and raster, then the texture tail.
    front_span = "sr.clip_front" if rp.clip_near else "sr.front"
    with span(front_span):
        tris = None if rp.clip_near else mesh.triangles().long()
        # The clip front-end gathers its corners and attribute values
        # itself.
        chans, attrs, params, has_light, has_texture = shading_inputs(
            rp, with_attrs=table is None and not rp.clip_near)
        # The JAX package's budgets for the banded layout: culled scenes
        # emit about half the pairs, and bands emit ~1.3-1.5x more pairs
        # than whole tiles.
        budget = 0.85 if rp.cull_backfaces else 3.0
        persp = rp.perspective_correct and bool(chans)
        kw = dict(width=rp.width, height=out_h, y_start=y0,
                  pair_budget_factor=budget)
        plan = dict(chans=chans, has_light=has_light,
                    has_texture=has_texture, perspective=persp)
        n_attr = sum(size for _, size in chans)

        if rp.clip_near:
            args, ckw = clip_front_inputs(rp, chans)
            sources, nm = args[2], args[3]

            def geometry(positions, transform, *xs):
                # xs: the vertex attribute arrays in channel order, the
                # normal matrix (with a normal channel and a model), the
                # shading row. One launch on the card.
                with span("sr.clip_front"):
                    ps, tbl = clip_front_table(
                        positions, mesh.indices,
                        [(x, rot) for x, (_, rot) in zip(xs, sources)],
                        xs[len(sources)] if nm is not None else None,
                        transform, *args[5:], **ckw)
                return pipeline(ps, tbl, xs[-1] if chans else None)

            inputs = [mesh.positions, rp.transform]
            inputs += [values for values, _ in sources]
            if nm is not None:
                inputs.append(nm)
        elif front is not None:
            names = [f.name for f in dataclasses.fields(fe.PlanarSetup)]

            if table is not None and table[1] != n_attr + persp:
                raise ValueError(f"the stream table has {table[1]} "
                                 f"channels, this pass {n_attr + persp}")

            def geometry(*xs):
                # xs: the front's columns, 3 columns per attribute channel
                # (none with a table), the shading row. Without a table
                # the stream table is built from the front.
                with span("sr.front"):
                    ps = fe.PlanarSetup(*xs[:len(names)])
                    tbl = table
                    if tbl is None:
                        cols = [tuple(xs[len(names) + 3 * i:
                                         len(names) + 3 * i + 3])
                                for i in range(n_attr)]
                        if persp:
                            cols = fe.perspective_chan_vals(cols, ps)
                        tbl = stream_table_of(ps, cols)
                return pipeline(ps, tbl, xs[-1] if chans else None)

            inputs = [getattr(front, n) for n in names]
            if table is None:
                inputs += [c for cols in _pad_cols(attrs,
                                                   front.num_triangles)
                           for c in cols]
        else:
            def geometry(*xs):
                # xs: 9 corner columns, the transform, 3 columns per
                # attribute channel, the shading row. One front-end launch
                # writes the setup and the stream table.
                with span("sr.front"):
                    cols = [tuple(xs[10 + 3 * i:13 + 3 * i])
                            for i in range(n_attr)]
                    ps, *tbl = fe.planar_front_table(
                        (xs[0:3], xs[3:6], xs[6:9]), xs[9], cols, rp.width,
                        rp.height, cull_backfaces=rp.cull_backfaces,
                        perspective=persp)
                return pipeline(ps, tbl, xs[-1] if chans else None)

            corners = fe.corner_cols(mesh.positions[tris])
            inputs = [c for corner in corners for c in corner]
            inputs += [rp.transform] + [c for cols in attrs for c in cols]

    def pipeline(ps, tbl, params):
        # The bins, spill and raster of the planar setup ``ps`` and its
        # stream table: binned_pipeline's visibility pass without channels.
        if not chans:
            return binned_pipeline(ps, None, stream_table=tbl, **kw)[:2]
        return fused_pipeline(ps, None, params, stream_table=tbl, **plan,
                              **kw)

    if not chans:
        depth, tri_id = _stop_geometry_grads(geometry, *inputs)
        with span("sr.texture_tail"):
            color = shade_gbuffer(None, tri_id != -1, shading=rp.shading,
                                  chans=chans, light=rp.light,
                                  texture=rp.texture,
                                  flat_color=rp.flat_color)
        return Framebuffer(color=color, depth=depth)
    # Texture gradients flow through finish_fused, outside the region.
    depth, tri_id, out = _stop_geometry_grads(geometry, *inputs, params)
    with span("sr.texture_tail"):
        out_chans = fused_output_channels(rp.shading, chans, has_light,
                                          has_texture)
        color = texture_tail(out, tri_id, out_chans=out_chans,
                             light=rp.light, texture=rp.texture)
    return Framebuffer(color=color, depth=depth)


def _primitive_inputs(rp: RenderPass):
    """The vertex stage of a line or point RenderPass: (screen [N, 3],
    the cleared [H, W, 4] color, per-vertex colors, white where the mesh
    has none)."""
    mesh = rp.mesh
    screen, _ = vertex_stage(mesh.positions, rp.transform, rp.width,
                             rp.height)
    dev = mesh.positions.device
    color = torch.tensor(CLEAR_COLOR, dtype=torch.float32,
                         device=dev).expand(rp.height, rp.width, 4)
    colors = mesh.colors if mesh.colors is not None else torch.ones(
        (mesh.num_vertices, 3), dtype=torch.float32, device=dev)
    return screen, color, colors


def _clear_depth(rp: RenderPass):
    return torch.full((rp.height, rp.width), CLEAR_DEPTH,
                      dtype=torch.float32, device=rp.mesh.positions.device)


def render_lines(rp: RenderPass) -> Framebuffer:
    """``primitive="line"``: each index pair a DDA line, colors
    interpolated along it (ops/lines.py); depth stays cleared."""
    screen, color, colors = _primitive_inputs(rp)
    color = lines_ops.draw_lines(color, screen, rp.mesh.lines(), colors)
    return Framebuffer(color=color, depth=_clear_depth(rp))


def render_points(rp: RenderPass) -> Framebuffer:
    """``primitive="point"``/``"vertices"``: each indexed vertex one
    pixel (ops/lines.py); depth stays cleared."""
    screen, color, colors = _primitive_inputs(rp)
    idx = rp.mesh.indices.long()
    color = lines_ops.draw_points(color, screen[idx], colors[idx])
    return Framebuffer(color=color, depth=_clear_depth(rp))


def render_rows(rp: RenderPass, y_start: int, rows: int,
                backend: str = "auto",
                front: Optional[fe.PlanarSetup] = None,
                table=None) -> Framebuffer:
    """Rows [y_start, y_start + rows) of the frame with the full frame's
    semantics (:func:`render_triangles`); ``front`` and ``table`` as it
    takes them."""
    if rp.primitive != "triangle":
        raise NotImplementedError("row slicing applies to the triangle path")
    return render_triangles(rp, backend, y_start=y_start, rows=rows,
                            front=front, table=table)


def render(rp: RenderPass, backend: str = "auto") -> Framebuffer:
    """Render one frame: triangles on ``backend``, or lines or points
    (which take no backend)."""
    if tuple(rp.transform.shape) != (4, 4):
        raise TypeError(
            f"render takes one [4, 4] transform, got "
            f"{tuple(rp.transform.shape)}; render a batch of transforms "
            f"with parallel.batch.render_batch")
    with span("sr.render"):
        if rp.primitive == "triangle":
            return render_triangles(rp, backend)
        if rp.primitive == "line":
            return render_lines(rp)
        if rp.primitive in ("point", "vertices"):
            return render_points(rp)
    raise ValueError(f"unknown primitive {rp.primitive!r}")
