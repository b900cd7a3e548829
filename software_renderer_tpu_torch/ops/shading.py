"""Fragment shading: channel plans, the deferred shading of a visibility
buffer (``shade``, ``shade_gbuffer``: the ``reference`` and ``pallas``
backends and attribute-free binned frames), and the fused path's
per-frame parameter row, in-kernel epilogue and texture tail.

``fused_epilogue`` is written as plain elementwise torch over lists of
2D planes. It is the plain version of the epilogue that the CUDA fused
kernel (csrc/fused.cu) runs per pixel; the kernel evaluates the same
expressions in the same order, with ``1/sqrt`` (never ``rsqrt``) so that
the normalisation rounds identically. ``perspective_epilogue`` around it
is the plain version of the kernel's perspective plan.

The texture tail after the fused kernel (``texture_tail``) is one launch
of csrc/tail.cu (``tail_kernel``: quad-table sample, combine, mask and
RGBA store per pixel) on every card frame that needs no gradient,
untextured or bilinear on sampler route "0" (``tail_kernel_plan``).
``finish_fused``, its plain version in torch operations, keeps the CPU,
texture training (the gradient flows through it), trilinear and nearest
filters and the windowed routes; the kernel's colour equals it bit for
bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import _cuda
from ..device import on_device, or_default
from ..framebuffer import NO_TRIANGLE
from . import texture as _texture
from .resolve import (barycentrics_at_pixels, interpolate_attribute,
                      perspective_correct_weights)
from .texture import (Texture, sample_texture,
                      sample_texture_planes_compacted,
                      sample_texture_planes_trilinear_compacted)


@dataclasses.dataclass
class Light:
    """Directional light + Blinn-Phong material response."""

    direction: torch.Tensor   # [3] direction the light travels
    color: torch.Tensor       # [3]
    ambient: torch.Tensor     # [3]
    specular: torch.Tensor    # [3]
    shininess: torch.Tensor   # [] float

    @staticmethod
    def default(device=None) -> "Light":
        """The reference's light, on the card unless ``device`` says
        otherwise (device.py)."""
        device = or_default(device)
        f = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return Light(direction=f([0.3, -0.5, 0.8]), color=f([1.0, 1.0, 1.0]),
                     ambient=f([0.15, 0.15, 0.15]),
                     specular=f([0.5, 0.5, 0.5]), shininess=f(32.0))

    def to(self, device) -> "Light":
        return Light(*(getattr(self, f.name).to(device)
                       for f in dataclasses.fields(self)))


def _normalize(v, eps: float = 1e-12):
    # 1/sqrt, not rsqrt: see the module docstring.
    return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True),
                                      min=eps))


def attribute_channels(shading: str, has_colors: bool, has_light: bool):
    """G-buffer channel plan for a shading mode: list of (name, size)."""
    if shading == "vertex":
        return [("rgb", 3)]
    if shading == "flat":
        return []
    if shading == "phong":
        chans = [("rgb", 3)] if has_colors else []
        return chans + ([("normal", 3)] if has_light else [])
    if shading == "textured":
        chans = []
        if has_colors:
            chans.append(("rgb", 3))
        if has_light:
            chans.append(("normal", 3))
        return chans + [("uv", 2)]
    raise ValueError(f"unknown shading mode {shading!r}")


def gather_attribute_values(shading: str, tris, colors=None, normals=None,
                            uvs=None, has_light: bool = True):
    """Per-vertex attributes stacked per the channel plan: ([T, 3, A]
    or None when the plan has no channels, chans)."""
    chans = attribute_channels(shading, colors is not None, has_light)
    src = {"rgb": colors, "normal": normals, "uv": uvs}
    parts = [src[name][tris] for name, _ in chans]
    return (torch.cat(parts, dim=-1) if parts else None), chans


def shade_gbuffer(gb, covered, *, shading: str, chans,
                  light: Optional[Light] = None,
                  texture: Optional[Texture] = None,
                  flat_color=(1.0, 1.0, 1.0), normal_matrix=None,
                  view_dir=(0.0, 0.0, -1.0)):
    """Lighting and texturing from an interpolated G-buffer.

    gb: [H, W, A] laid out per ``chans`` (None when ``chans`` is empty);
    covered: [H, W] bool. Returns [H, W, 4] RGBA, transparent black where
    uncovered.
    """
    offsets, off = {}, 0
    for name, size in chans:
        offsets[name] = (off, off + size)
        off += size
    chan = lambda name: gb[..., offsets[name][0]:offsets[name][1]]
    f = lambda v: on_device(v, covered.device)
    if shading == "flat" or ("rgb" not in offsets
                             and shading in ("phong", "textured")):
        base = f(flat_color).expand(covered.shape + (3,))
    elif "rgb" in offsets:
        base = chan("rgb")
    else:
        raise ValueError(f"no color source for shading {shading!r}")
    if shading == "textured":
        tex_rgb = sample_texture(texture, chan("uv"))[..., :3]
        base = tex_rgb if "rgb" not in offsets else base * tex_rgb
    if shading in ("phong", "textured") and light is not None \
            and "normal" in offsets:
        n = chan("normal")
        if normal_matrix is not None:
            n = n @ normal_matrix.T
        n = _normalize(n)
        l = -_normalize(f(light.direction))
        v = _normalize(f(view_dir))
        ndotl = torch.clamp((n * l).sum(-1, keepdim=True), min=0.0)
        h = _normalize(l + v)
        ndoth = torch.clamp((n * h).sum(-1, keepdim=True), min=0.0)
        spec = torch.pow(ndoth, light.shininess) * torch.sign(ndotl)
        rgb = (base * (light.ambient + light.color * ndotl)
               + light.specular * spec)
    else:
        rgb = base
    alpha = covered.to(torch.float32)[..., None]
    rgb = torch.where(covered[..., None], rgb, 0.0)
    return torch.cat([rgb, alpha], dim=-1)


def shade(setup, tri_id, tris, *, shading: str, colors=None, normals=None,
          uvs=None, light: Optional[Light] = None,
          texture: Optional[Texture] = None, flat_color=(1.0, 1.0, 1.0),
          normal_matrix=None, view_dir=(0.0, 0.0, -1.0), y_start: int = 0,
          w_tri=None, corner_attrs=None):
    """Shade a frame from its visibility buffer.

    setup: the TriangleSetup the ids index; tri_id: [H, W] int32; tris:
    [T, 3] vertex indices into the per-vertex ``colors``/``normals``/
    ``uvs``. Interpolates the plan's channels with the winners'
    barycentric weights (perspective-correct ones when ``w_tri``, the
    [T, 3] clip-space w of the corners, is given), then
    :func:`shade_gbuffer`. Returns [H, W, 4].

    corner_attrs: optional ([T, 3, A] values, chans) used instead of the
    per-vertex gather, for triangle lists that do not index the mesh (the
    near-plane clip's [2T] triangles, ops/clip.py ``compose_attrs``).
    """
    if shading == "vertex" and colors is None:
        raise ValueError("'vertex' shading requires per-vertex colors")
    if shading == "textured" and (uvs is None or texture is None):
        raise ValueError("'textured' shading requires uvs + texture")
    if corner_attrs is not None:
        attrs, chans = corner_attrs
    else:
        attrs, chans = gather_attribute_values(
            shading, tris, colors=colors, normals=normals, uvs=uvs,
            has_light=light is not None and normals is not None)
    covered = tri_id != NO_TRIANGLE
    gb = None
    if attrs is not None:
        ws, covered = barycentrics_at_pixels(setup, tri_id, y_start)
        if w_tri is not None:
            ws = perspective_correct_weights(ws, w_tri, tri_id, covered)
        gb = interpolate_attribute(attrs, tri_id, ws, covered)
    return shade_gbuffer(gb, covered, shading=shading, chans=chans,
                         light=light, texture=texture, flat_color=flat_color,
                         normal_matrix=normal_matrix, view_dir=view_dir)


# Params-row layout (float32[PARAMS_WIDTH]):
# 0:3 l (unit, toward light) | 3:6 h (unit half vector) | 6:9 light color
# | 9:12 ambient | 12:15 specular | 15 shininess | 16:19 flat_color
PARAMS_WIDTH = 32


def shading_params(light: Optional[Light], flat_color=(1.0, 1.0, 1.0),
                   view_dir=(0.0, 0.0, -1.0), device=None) -> torch.Tensor:
    """Pack the per-frame shading constants into one float32 row, on
    ``device``; where it is None, on the device of ``flat_color`` or the
    light, else the card (device.py). Host values (``view_dir``, a CPU
    ``flat_color``) reach the card through ``device.constant``: no
    host-to-card copy per frame."""
    if device is None:
        if isinstance(flat_color, torch.Tensor):
            device = flat_color.device
        elif light is not None:
            device = light.direction.device
    device = or_default(device)
    f = lambda v: on_device(v, device)
    p = torch.zeros(PARAMS_WIDTH, dtype=torch.float32, device=device)
    if light is not None:
        l = -_normalize(f(light.direction))
        h = _normalize(l + _normalize(f(view_dir)))
        p[0:3] = l
        p[3:6] = h
        p[6:9] = f(light.color)
        p[9:12] = f(light.ambient)
        p[12:15] = f(light.specular)
        p[15] = f(light.shininess)
    p[16:19] = f(flat_color)
    return p


def fused_output_channels(shading: str, chans, has_light: bool,
                          has_texture: bool):
    """Output channel plan of the fused epilogue: list of (name, size).

    'lit' = base * (ambient + light * ndotl) before texturing, 'spec' =
    the scalar specular term, 'final'/'rgb' = finished color, 'uv' =
    passthrough for the texture tail.
    """
    names = {n for n, _ in chans}
    lit = has_light and "normal" in names
    out = []
    if shading in ("vertex", "flat") or not has_texture:
        out.append(("final", 3) if lit else ("rgb", 3))
    else:
        out.append(("lit", 3) if lit else ("rgb", 3))
        if lit:
            out.append(("spec", 1))
    if has_texture:
        out.append(("uv", 2))
    return out


def _chan_offset(chans, name):
    off = 0
    for n, size in chans:
        if n == name:
            return off
        off += size
    return None


def _chan_planes(planes, chans, name):
    """Channel ``name``'s planes out of a list laid out per ``chans``."""
    off = _chan_offset(chans, name)
    if off is None:
        return None
    return list(planes[off:off + dict(chans)[name]])


def fused_epilogue(planes, covered, params, *, chans, has_light: bool,
                   has_texture: bool):
    """Interpolated channel planes -> fused output planes.

    planes: list over the channels of ``chans`` of equally shaped float32
    tensors; covered: bool tensor of that shape; params: the
    :func:`shading_params` row. Returns the planes of
    :func:`fused_output_channels`, zero where uncovered.
    """
    rgb = _chan_planes(planes, chans, "rgb")
    nrm = _chan_planes(planes, chans, "normal")
    uv = _chan_planes(planes, chans, "uv")
    one = torch.ones_like(covered, dtype=torch.float32)
    base = rgb if rgb is not None else [params[16 + c] * one
                                        for c in range(3)]
    outs = []
    if has_light and nrm is not None:
        inv = 1.0 / torch.sqrt(torch.clamp(
            nrm[0] * nrm[0] + nrm[1] * nrm[1] + nrm[2] * nrm[2], min=1e-12))
        nx, ny, nz = nrm[0] * inv, nrm[1] * inv, nrm[2] * inv
        ndotl = torch.clamp(nx * params[0] + ny * params[1] + nz * params[2],
                            min=0.0)
        ndoth = torch.clamp(nx * params[3] + ny * params[4] + nz * params[5],
                            min=0.0)
        spec = torch.pow(ndoth, params[15]) * torch.sign(ndotl)
        lit_rgb = [base[c] * (params[9 + c] + params[6 + c] * ndotl)
                   for c in range(3)]
        if has_texture:
            outs += lit_rgb
            outs.append(spec)
        else:
            outs += [lit_rgb[c] + params[12 + c] * spec for c in range(3)]
    else:
        outs += base
    if has_texture:
        outs += uv
    zero = torch.zeros_like(one)
    return [torch.where(covered, o, zero) for o in outs]


def perspective_epilogue(planes, covered, params, *, inner):
    """The perspective plan around a fused epilogue ``inner``.

    planes: A screen-affine ``attr / w`` planes, then the ``1 / w`` plane
    (:func:`perspective_vertex_attrs`, ops/frontend.py
    ``perspective_chan_vals``). On covered pixels the interpolated 1/w is
    > 0 (the near-plane cull or clip keeps every corner's w > 0), and each
    numerator divided by it is the perspective-correct attribute, the
    weights of ops/resolve.py ``perspective_correct_weights``; uncovered
    pixels divide by 1 and ``inner`` zeroes them.
    """
    invw = planes[-1]
    one = torch.ones_like(invw)
    rec = one / torch.where(covered, invw, one)
    return inner([p * rec for p in planes[:-1]], covered, params)


def perspective_vertex_attrs(attrs, w_corners):
    """[T, 3, A] attributes and [T, 3] clip-space w -> [T, 3, A + 1]: each
    attribute over its corner's w, then 1/w (a 0 taken as 1)."""
    invw = 1.0 / torch.where(w_corners == 0.0, 1.0, w_corners)
    return torch.cat([attrs * invw[:, :, None], invw[:, :, None]], dim=-1)


def finish_fused(out_cf, covered, *, out_chans,
                 light: Optional[Light] = None,
                 texture: Optional[Texture] = None):
    """Tail after the fused kernel: texture sample + combine + alpha, in
    torch operations. The plain version of :func:`tail_kernel`, and the
    tail of every frame :func:`tail_kernel_plan` refuses.

    out_cf: [C, H, W] fused epilogue outputs. Returns [H, W, 4] RGBA.
    """
    names = {n for n, _ in out_chans}
    planes = list(out_cf.unbind(0))
    rgb = list(_chan_planes(planes, out_chans, "final")
               or _chan_planes(planes, out_chans, "rgb")
               or _chan_planes(planes, out_chans, "lit"))
    if "uv" in names and texture is not None:
        u, v = _chan_planes(planes, out_chans, "uv")
        if texture.filter == "trilinear":
            tex = sample_texture_planes_trilinear_compacted(texture, u, v,
                                                            covered)
        else:
            tex = sample_texture_planes_compacted(texture, u, v, covered)
        if len(tex) == 1:  # a single-channel texture broadcasts
            tex = tex * 3
        rgb = [rgb[c] * tex[c] for c in range(3)]
    if "spec" in names:
        spec = _chan_planes(planes, out_chans, "spec")[0]
        ks = light.specular.to(torch.float32)
        rgb = [rgb[c] + ks[c] * spec for c in range(3)]
    zero = torch.zeros_like(covered, dtype=torch.float32)
    one = torch.ones_like(covered, dtype=torch.float32)
    rgb = [torch.where(covered, p, zero) for p in rgb]
    alpha = torch.where(covered, one, zero)
    return torch.stack(rgb + [alpha], dim=-1)


# The fused output plans the tail kernel serves (csrc/tail.cu): the
# colour planes alone, rgb + uv, and lit + spec + uv -> its plan number.
TAIL_PLANS = {("final",): 0, ("rgb",): 0, ("rgb", "uv"): 1,
              ("lit", "spec", "uv"): 2}


def tail_kernel_plan(out_cf, out_chans, light: Optional[Light] = None,
                     texture: Optional[Texture] = None) -> Optional[int]:
    """The tail kernel's plan for these inputs (:data:`TAIL_PLANS`), or
    None where :func:`finish_fused`'s torch operations keep the frame:
    a gradient may be needed (grad mode on and ``out_cf``, the texture's
    table or the specular it reads requires grad), a channel plan outside
    :data:`TAIL_PLANS`, or, on a textured plan, a filter other than
    bilinear, a sampler route other than "0" (``SR_TEX_WINDOWED``: routes
    "1" and "adaptive" take K7), or a texture of other than 1, 3 or 4
    channels. The device is the caller's test (:func:`texture_tail`)."""
    plan = TAIL_PLANS.get(tuple(n for n, _ in out_chans))
    if plan is None:
        return None
    reads = [out_cf]
    if plan:
        if (texture is None or texture.filter != "bilinear"
                or _texture.TEX_WINDOWED != "0"
                or texture.data.shape[-1] not in (1, 3, 4)):
            return None
        reads.append(texture.table)
    if plan == 2:
        if light is None:
            return None
        reads.append(light.specular)
    if torch.is_grad_enabled() and any(t.requires_grad for t in reads):
        return None
    return plan


def tail_kernel(out_cf, tri_id, *, out_chans,
                light: Optional[Light] = None,
                texture: Optional[Texture] = None):
    """The texture tail in one launch (csrc/tail.cu) on CUDA tensors:
    :func:`finish_fused` of ``out_cf`` and the covered mask ``tri_id !=
    NO_TRIANGLE``, bit for bit, with no autograd. out_cf: [C, H, W]
    float32, a plan of :data:`TAIL_PLANS`; tri_id: [H, W] int32. Returns
    a new [H, W, 4] float32 RGBA. The light's specular is read on the
    device, so a CUDA graph can capture the launch. CPU tensors run
    :func:`finish_fused`."""
    if out_cf.device.type == "cpu":
        return finish_fused(out_cf, tri_id != NO_TRIANGLE,
                            out_chans=out_chans, light=light,
                            texture=texture)
    dev = out_cf.device
    plan = TAIL_PLANS.get(tuple(n for n, _ in out_chans))
    if plan is None:
        raise ValueError(f"the tail kernel takes the plans {list(TAIL_PLANS)}"
                         f", got {out_chans}")
    n_planes = sum(size for _, size in out_chans)
    _cuda.require(out_cf, torch.float32, "out_cf", ndim=3)
    if out_cf.shape[0] != n_planes:
        raise ValueError(f"out_cf must hold {n_planes} planes, got "
                         f"{out_cf.shape[0]}")
    h, w = out_cf.shape[1:]
    if h * w >= 2 ** 31:
        raise ValueError(f"a {h}x{w} frame has more pixels than an int32")
    _cuda.require(tri_id, torch.int32, "tri_id", device=dev, shape=(h, w))
    table = specular = None
    th = tw = c = repeat = 0
    if plan:
        if texture is None or texture.filter != "bilinear":
            raise ValueError("a textured plan takes a bilinear texture")
        th, tw, c = texture.data.shape
        if c not in (1, 3, 4):
            raise ValueError(f"the texture must have 1, 3 or 4 channels, "
                             f"got {c}")
        repeat = int(texture.wrap == "repeat")
        table = texture.table
        _cuda.require(table, torch.float32, "texture table", device=dev,
                      shape=(th * tw, 4 * c), align=16)
    if plan == 2:
        specular = light.specular.to(torch.float32).contiguous()
        _cuda.require(specular, torch.float32, "specular", device=dev,
                      shape=(3,))
    out = torch.empty((h, w, 4), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = _cuda.lib()
    _cuda.launches["tail"] += 1
    _cuda.check(lib.sr_tail(
        out_cf.data_ptr(), tri_id.data_ptr(), h * w, plan, ptr(table), th,
        tw, c, repeat, ptr(specular), out.data_ptr(), _cuda.sm_count(dev),
        _cuda.stream_of(out_cf)))
    return out


def texture_tail(out_cf, tri_id, *, out_chans,
                 light: Optional[Light] = None,
                 texture: Optional[Texture] = None):
    """The fused path's texture tail, ``render``'s last layer: [C, H, W]
    fused outputs and the [H, W] triangle ids -> [H, W, 4] RGBA. On the
    card, where :func:`tail_kernel_plan` finds a plan (every frame that
    needs no gradient, on the bilinear route "0" or untextured), one
    :func:`tail_kernel` launch; everywhere else :func:`finish_fused`."""
    if (out_cf.device.type == "cuda"
            and tail_kernel_plan(out_cf, out_chans, light, texture)
            is not None):
        return tail_kernel(out_cf, tri_id, out_chans=out_chans, light=light,
                           texture=texture)
    return finish_fused(out_cf, tri_id != NO_TRIANGLE, out_chans=out_chans,
                        light=light, texture=texture)
