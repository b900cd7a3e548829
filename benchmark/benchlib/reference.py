"""The plain reference renderer: plain PyTorch, in tiles, importing
nothing of the program.

It renders what the program is asked to render, from the same inputs
(the scene arrays, the transform, the texture and the light), by the
published rules of the JAX package's renderer:

* vertices through four multiply-add chains, the divide by w, NDC to
  pixels rounded half away from zero; a triangle with a corner at
  w <= CLIP_EPS culled, or with ``clip_near`` cut at w = CLIP_EPS into at
  most two triangles (slot t and slot T + t, Sutherland-Hodgman over a
  fixed case table);
* exact sign-folded edge functions on the rounded pixel coordinates,
  tested at pixel centres inside each triangle's clamped bbox, and the
  depth plane; a pixel keeps the least depth, ties going to the lower
  triangle id;
* the winner's attributes by barycentric weights (perspective-correct
  with ``perspective_correct``), then the configuration's ``shading``
  (:data:`SHADINGS`): the vertex colour, or a flat one; Blinn-Phong
  under a directional light; or Blinn-Phong over a texture sampled with
  its ``filter`` (:data:`FILTERS`) and ``wrap`` (:data:`WRAPS`).

Visibility tests every pixel of every triangle's bbox, in blocks of at
most :data:`BLOCK` (pixel, triangle) candidates, and keeps each pixel's
least (depth, id) key with one ``scatter_reduce``. ``dtype`` is the
precision of every floating-point step (the control computes it in
bfloat16); depth keys compare in float32.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# The near-plane threshold of the renderer (float32 rounding of 1e-6).
CLIP_EPS = float(np.float32(1e-6))
# Candidates (pixel, triangle) per visibility block.
BLOCK = 1 << 25

# What the reference draws: a configuration asking for anything else is
# refused (benchlib/inputs.py).
SHADINGS = ("textured", "phong", "vertex", "flat")
LIT = ("textured", "phong")
FILTERS = ("bilinear", "nearest")
WRAPS = ("repeat", "clamp")
# A configuration's precision: the reference's dtype, and the control's,
# the nearest precision below it.
PRECISIONS = {"float32": torch.float32}
CONTROL = {"float32": torch.bfloat16}

# Output quad per behind-mask case (b0 + 2 b1 + 4 b2); candidates 0-2
# are the corners, 3-5 the cuts of edges (0, 1), (1, 2), (2, 0).
_QUAD = [[0, 1, 2, 2], [5, 3, 1, 2], [0, 3, 4, 2], [5, 4, 2, 2],
         [5, 0, 1, 4], [3, 1, 4, 4], [5, 0, 3, 3], [0, 0, 0, 0]]
_SECOND = [False, True, True, False, True, False, False, False]


@dataclasses.dataclass
class Frame:
    color: torch.Tensor   # [H, W, 4]
    depth: torch.Tensor   # [H, W] float32, +inf where uncovered
    ids: torch.Tensor     # [H, W] int64, -1 where uncovered


@dataclasses.dataclass
class Geometry:
    """Screen-space triangles of one frame (leading dim T', the
    triangles after the clip)."""

    x: torch.Tensor       # [T', 3] rounded pixel x of the corners
    y: torch.Tensor       # [T', 3]
    z: torch.Tensor       # [T', 3] NDC z
    w: torch.Tensor       # [T', 3] clip-space w
    valid: torch.Tensor   # [T'] bool
    src: torch.Tensor     # [T'] source triangle
    bary: torch.Tensor    # [T', 3, 3] corner weights over the source's


def _round_half_away(x):
    return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)


def clip_space(corners, m):
    """[T, 3, 3] corners, [4, 4] transform -> [T, 3, 4]."""
    x, y, z = corners[..., 0], corners[..., 1], corners[..., 2]
    return torch.stack([m[i, 0] * x + m[i, 1] * y + m[i, 2] * z + m[i, 3]
                        for i in range(4)], dim=-1)


def _clip(clip):
    """Cut [T, 3, 4] triangles at w = CLIP_EPS: ([2T, 3, 4] corners,
    [2T, 3, 3] weights over the source corners, [2T] bool)."""
    t, dev, dt = clip.shape[0], clip.device, clip.dtype
    w = clip[..., 3]
    behind = (w < CLIP_EPS).long()
    case = behind[:, 0] + 2 * behind[:, 1] + 4 * behind[:, 2]
    pts = [clip[:, 0], clip[:, 1], clip[:, 2]]
    eye = torch.eye(3, dtype=dt, device=dev)
    wts = [eye[0].expand(t, 3), eye[1].expand(t, 3), eye[2].expand(t, 3)]
    for a, b in ((0, 1), (1, 2), (2, 0)):
        den = w[:, b] - w[:, a]
        s = (CLIP_EPS - w[:, a]) / torch.where(den.abs() > 0, den,
                                               torch.ones_like(den))
        pts.append(clip[:, a] + s[:, None] * (clip[:, b] - clip[:, a]))
        e = torch.zeros((t, 3), dtype=dt, device=dev)
        e[:, a] = 1.0 - s
        e[:, b] = s
        wts.append(e)
    pts, wts = torch.stack(pts, 1), torch.stack(wts, 1)
    sel = torch.tensor(_QUAD, device=dev)[case]
    qp = torch.gather(pts, 1, sel[..., None].expand(-1, -1, 4))
    qw = torch.gather(wts, 1, sel[..., None].expand(-1, -1, 3))
    second = torch.tensor([0, 2, 3], device=dev)
    valid = torch.cat([case != 7,
                       torch.tensor(_SECOND, device=dev)[case]])
    return (torch.cat([qp[:, :3], qp[:, second]]),
            torch.cat([qw[:, :3], qw[:, second]]), valid)


def geometry(positions, indices, transform, width, height, *,
             clip_near=False, dtype=torch.float32) -> Geometry:
    """Model-space mesh -> screen-space triangles."""
    tris = indices.reshape(-1, 3).long()
    t = tris.shape[0]
    clip = clip_space(positions.to(dtype)[tris], transform.to(dtype))
    if clip_near:
        clip, bary, valid = _clip(clip)
        src = torch.arange(t, device=clip.device).repeat(2)
    else:
        valid = (clip[..., 3] > CLIP_EPS).all(dim=1)
        bary = torch.eye(3, dtype=dtype, device=clip.device).expand(t, 3, 3)
        src = torch.arange(t, device=clip.device)
    w = clip[..., 3]
    wg = torch.where(w == 0, torch.ones_like(w), w)
    u = (clip[..., 0] / wg) * 0.5 + 0.5
    v = (clip[..., 1] / wg) * -0.5 + 0.5
    return Geometry(x=_round_half_away(u * width),
                    y=_round_half_away(v * height), z=clip[..., 2] / wg,
                    w=w, valid=valid, src=src, bary=bary)


@dataclasses.dataclass
class Setup:
    a0: torch.Tensor
    b0: torch.Tensor
    c0: torch.Tensor
    a1: torch.Tensor
    b1: torch.Tensor
    c1: torch.Tensor
    abs_d: torch.Tensor
    inv_area: torch.Tensor
    zx: torch.Tensor
    zy: torch.Tensor
    zc: torch.Tensor
    box: torch.Tensor     # [T', 4] int64 x0 y0 x1 y1, inclusive
    valid: torch.Tensor   # [T'] bool


def setup(g: Geometry, width, height, *, cull_backfaces=True) -> Setup:
    """Edge functions, |D|, depth plane, bbox and validity."""
    (x1, x2, x3), (y1, y2, y3), (z1, z2, z3) = (
        g.x.unbind(1), g.y.unbind(1), g.z.unbind(1))
    d = (x1 - x3) * (y2 - y3) - (x2 - x3) * (y1 - y3)
    finite = torch.stack([torch.isfinite(c) for c in
                          (x1, y1, z1, x2, y2, z2, x3, y3, z3)]).all(0)
    degenerate = ~finite | (d == 0)
    one = torch.ones_like(d)
    s = torch.where(d < 0, -one, one)
    abs_d = d.abs()
    inv_area = torch.where(degenerate, 0 * one,
                           1.0 / torch.where(degenerate, one, abs_d))
    a0, b0 = (y2 - y3) * s, (x3 - x2) * s
    a1, b1 = (y3 - y1) * s, (x1 - x3) * s
    c0, c1 = -(a0 * x3 + b0 * y3), -(a1 * x3 + b1 * y3)
    a2, b2, c2 = -(a0 + a1), -(b0 + b1), abs_d - c0 - c1
    zx = (a0 * z1 + a1 * z2 + a2 * z3) * inv_area
    zy = (b0 * z1 + b1 * z2 + b2 * z3) * inv_area
    zc = (c0 * z1 + c1 * z2 + c2 * z3) * inv_area
    lo_x = torch.minimum(torch.minimum(x1, x2), x3)
    hi_x = torch.maximum(torch.maximum(x1, x2), x3)
    lo_y = torch.minimum(torch.minimum(y1, y2), y3)
    hi_y = torch.maximum(torch.maximum(y1, y2), y3)
    off = (hi_x < 0) | (lo_x > width) | (hi_y < 0) | (lo_y > height)

    def edge(v, n):
        v = torch.where(torch.isfinite(v), v, 0 * v).float()
        return torch.clamp(v, 0, n - 1).long()

    box = torch.stack([edge(torch.floor(lo_x), width),
                       edge(torch.floor(lo_y), height),
                       edge(torch.ceil(hi_x), width),
                       edge(torch.ceil(hi_y), height)], dim=1)
    valid = g.valid & ~degenerate & ~off
    if cull_backfaces:
        valid = valid & (d > 0)
    return Setup(a0, b0, c0, a1, b1, c1, abs_d, inv_area, zx, zy, zc, box,
                 valid)


def cut_pixels(scene, transform, ids):
    """[H, W] bool: the pixels whose winner (``ids``, as :func:`render`
    gives them) is a piece of a triangle that the near plane cuts."""
    tris = scene["indices"].reshape(-1, 3).long()
    t = tris.shape[0]
    w = clip_space(scene["positions"][tris], transform)[..., 3]
    cut = (w < CLIP_EPS).any(1)
    return (ids >= t) | ((ids >= 0) & cut[ids.clamp(0, t - 1)])


def _depth_key(depth, ids):
    """int64 keys ordered as (depth, id): float32 bits made monotone."""
    bits = (depth.float() + 0.0).view(torch.int32)
    mono = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    return (mono.long() << 32) | ids


def visibility(st: Setup, width, height, block=BLOCK, on_block=None):
    """(depth [H, W] float32, ids [H, W] int64): per pixel the least
    (depth, id) over the triangles that cover its centre. ``on_block(t,
    inside)`` sees each block's candidates."""
    dev = st.a0.device
    none = torch.iinfo(torch.int64).max
    keys = torch.full((height * width,), none, dtype=torch.int64,
                      device=dev)
    tid = torch.nonzero(st.valid).flatten()
    box = st.box[tid]
    bw = box[:, 2] - box[:, 0] + 1
    n = bw * (box[:, 3] - box[:, 1] + 1)
    ends = torch.cumsum(n, 0).tolist()
    lo = 0
    while lo < len(ends):
        base = ends[lo - 1] if lo else 0
        hi = max(lo + 1, int(np.searchsorted(ends, base + block,
                                             side="right")))
        k = torch.arange(lo, hi, device=dev)
        cnt = n[k]
        who = torch.repeat_interleave(k, cnt)
        first = torch.cumsum(cnt, 0) - cnt
        off = (torch.arange(int(cnt.sum()), device=dev)
               - torch.repeat_interleave(first, cnt))
        px = box[who, 0] + off % bw[who]
        py = box[who, 1] + off // bw[who]
        t = tid[who]
        xs = px.to(st.a0.dtype) + 0.5
        ys = py.to(st.a0.dtype) + 0.5
        e0 = xs * st.a0[t] + ys * st.b0[t] + st.c0[t]
        e1 = xs * st.a1[t] + ys * st.b1[t] + st.c1[t]
        e2 = st.abs_d[t] - e0 - e1
        z = xs * st.zx[t] + ys * st.zy[t] + st.zc[t]
        inside = (e0 >= 0) & (e1 >= 0) & (e2 >= 0) & ~torch.isnan(z)
        if on_block is not None:
            on_block(t, inside)
        key = torch.where(inside, _depth_key(z, t), none)
        keys.scatter_reduce_(0, py * width + px, key, reduce="amin")
        lo = hi
    hit = keys != none
    ids = torch.where(hit, keys & 0xFFFFFFFF, -1)
    mono = (keys >> 32).to(torch.int32)
    bits = torch.where(mono >= 0, mono, mono ^ 0x7FFFFFFF)
    depth = torch.where(hit, bits.view(torch.float32),
                        torch.tensor(float("inf"), device=dev))
    return depth.reshape(height, width), ids.reshape(height, width)


def coverage_counts(st: Setup, width, height, block=BLOCK) -> dict:
    """What the frame needs of a rasterizer, counted from the inputs:
    the triangles that cover some pixel centre, the covered pixels and
    the covering (pixel, triangle) pairs."""
    covering = set()
    counts = dict(pairs=0)

    def on_block(t, inside):
        covering.update(torch.unique(t[inside]).tolist())
        counts["pairs"] += int(inside.sum())

    _, ids = visibility(st, width, height, block, on_block)
    return dict(triangles=len(covering), pixels=int((ids >= 0).sum()),
                pairs=counts["pairs"])


def _wrap(i, n, wrap):
    if wrap == "repeat":
        return torch.remainder(i, n)
    if wrap == "clamp":
        return torch.clamp(i, 0, n - 1)
    raise ValueError(f"unknown wrap {wrap!r}")


def sample(tex, u, v, filter="bilinear", wrap="repeat"):
    """Samples of ``tex`` [Th, Tw, C] at the (u, v) of [N] points:
    [N, C]. Bilinear weighs the quad whose corner is the wrapped texel
    at floor(u * Tw - 0.5) with its wrapped right and lower neighbours;
    nearest takes the wrapped texel at floor(u * Tw)."""
    th, tw = tex.shape[0], tex.shape[1]
    if filter == "nearest":
        xi = _wrap(torch.floor(u * tw).long(), tw, wrap)
        yi = _wrap(torch.floor(v * th).long(), th, wrap)
        return tex[yi, xi]
    if filter != "bilinear":
        raise ValueError(f"unknown filter {filter!r}")
    x = u * tw - 0.5
    y = v * th - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    xa, ya = _wrap(x0.long(), tw, wrap), _wrap(y0.long(), th, wrap)
    xb, yb = _wrap(xa + 1, tw, wrap), _wrap(ya + 1, th, wrap)
    t00, t01 = tex[ya, xa], tex[ya, xb]
    t10, t11 = tex[yb, xa], tex[yb, xb]
    top = t00 + (t01 - t00) * fx
    bot = t10 + (t11 - t10) * fx
    return top + (bot - top) * fy


def _normalize(v):
    return v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True),
                                      min=1e-12))


@dataclasses.dataclass
class Surface:
    """The covered pixels of a frame and what shading needs of them,
    independent of the texture: ``color = lit * texture(u, v) + spec``,
    with the texture where u is given and spec where it is given."""

    pix: torch.Tensor     # [P] flat pixel index of each covered pixel
    lit: torch.Tensor     # [P, 3] base, or base * (ambient + light * n.l)
    spec: Optional[torch.Tensor]   # [P, 3] specular * (n.h)^s * sign(n.l)
    u: Optional[torch.Tensor]      # [P] (textured shading)
    v: Optional[torch.Tensor]      # [P]


def surface(scene, g: Geometry, st: Setup, ids, *, shading="textured",
            perspective=False, dtype=torch.float32) -> Surface:
    """Interpolate the winners' attributes at the covered pixels and
    light them (everything but the texture)."""
    if shading not in SHADINGS:
        raise ValueError(f"unknown shading {shading!r}")
    h, w = ids.shape
    flat = ids.flatten()
    pix = torch.nonzero(flat >= 0).flatten()
    t = flat[pix]
    xs = (pix % w).to(dtype) + 0.5
    ys = (pix // w).to(dtype) + 0.5
    e0 = xs * st.a0[t] + ys * st.b0[t] + st.c0[t]
    e1 = xs * st.a1[t] + ys * st.b1[t] + st.c1[t]
    ws = torch.stack([e0, e1, st.abs_d[t] - e0 - e1], 1) * \
        st.inv_area[t][:, None]
    if perspective:
        wc = g.w[t]
        wr = ws / torch.where(wc == 0, torch.ones_like(wc), wc)
        den = wr.sum(1, keepdim=True)
        ws = wr / torch.where(den == 0, torch.ones_like(den), den)
    tris = scene["indices"].reshape(-1, 3).long()[g.src[t]]   # [P, 3]
    # Corner weights over the source corners: [P, 3 corners, 3 source].
    wsrc = (ws[:, :, None] * g.bary[t]).sum(1)                # [P, 3]

    def interp(attr):
        a = attr.to(dtype)[tris]                              # [P, 3, K]
        return (wsrc[:, :, None] * a).sum(1)

    if shading == "flat":
        base = scene["flat_color"].to(dtype).expand(pix.shape[0], 3)
    else:
        base = interp(scene["colors"])
    u = v = None
    if shading == "textured":
        uv = interp(scene["uvs"])
        u, v = uv[:, 0], uv[:, 1]
    light = scene["light"]
    if shading not in LIT or light is None:
        return Surface(pix=pix, lit=base, spec=None, u=u, v=v)
    n = interp(scene["normals"])
    nm = scene["normal_matrix"].to(dtype)
    n = _normalize(torch.stack([nm[i, 0] * n[:, 0] + nm[i, 1] * n[:, 1]
                                + nm[i, 2] * n[:, 2] for i in range(3)], 1))
    f = lambda k: torch.as_tensor(light[k], dtype=dtype, device=pix.device)
    l = -_normalize(f("direction"))
    hv = _normalize(l + _normalize(torch.tensor([0.0, 0.0, -1.0],
                                                dtype=dtype,
                                                device=pix.device)))
    ndotl = torch.clamp((n * l).sum(1, keepdim=True), min=0)
    ndoth = torch.clamp((n * hv).sum(1, keepdim=True), min=0)
    spec = torch.pow(ndoth, f("shininess")) * torch.sign(ndotl)
    return Surface(pix=pix, lit=base * (f("ambient") + f("color") * ndotl),
                   spec=f("specular") * spec, u=u, v=v)


def shade(surf: Surface, tex, h, w, filter="bilinear", wrap="repeat"):
    """[H, W, 4] color of a frame, alpha 1 on covered pixels, transparent
    black elsewhere. Differentiable in ``tex``."""
    rgb = surf.lit
    if surf.u is not None:
        rgb = rgb * sample(tex, surf.u, surf.v, filter, wrap)
    if surf.spec is not None:
        rgb = rgb + surf.spec
    rgba = torch.cat([rgb, torch.ones_like(rgb[:, :1])], 1)
    out = torch.zeros((h * w, 4), dtype=rgba.dtype, device=rgba.device)
    out = out.index_copy(0, surf.pix, rgba)
    return out.reshape(h, w, 4)


def texture_mode(cfg):
    """(filter, wrap) of the configuration's texture."""
    tx = cfg.get("texture") or {}
    return tx.get("filter", "bilinear"), tx.get("wrap", "repeat")


def render(scene, transform, cfg, *, dtype=torch.float32,
           shade_dtype: Optional[torch.dtype] = None,
           block=BLOCK) -> Frame:
    """One frame of ``scene`` (benchlib/inputs.py ``reference_scene``:
    positions, indices, colors, normals, uvs, texture, light, flat_color,
    normal_matrix) under ``transform``,
    as the configuration ``cfg`` draws it. ``dtype`` is the precision of
    the geometry and, unless ``shade_dtype`` says otherwise, of the
    shading."""
    width, height = cfg["width"], cfg["height"]
    sd = shade_dtype or dtype
    g = geometry(scene["positions"], scene["indices"], transform, width,
                 height, clip_near=cfg["clip_near"], dtype=dtype)
    st = setup(g, width, height, cull_backfaces=cfg["cull_backfaces"])
    depth, ids = visibility(st, width, height, block)
    if sd != dtype:
        g = dataclasses.replace(g, w=g.w.to(sd), bary=g.bary.to(sd))
        st = Setup(*(x.to(sd) if x.is_floating_point() else x
                     for x in dataclasses.astuple(st)))
    surf = surface(scene, g, st, ids, shading=cfg["shading"], dtype=sd,
                   perspective=cfg["perspective_correct"])
    tex = scene["texture"]
    color = shade(surf, None if tex is None else tex.to(sd), height, width,
                  *texture_mode(cfg))
    return Frame(color=color.float(), depth=depth, ids=ids)


def frame_surface(scene, transform, cfg, *, dtype=torch.float32,
                  block=BLOCK) -> Surface:
    """The texture-free part of a frame (for texture fitting)."""
    width, height = cfg["width"], cfg["height"]
    g = geometry(scene["positions"], scene["indices"], transform, width,
                 height, clip_near=cfg["clip_near"], dtype=dtype)
    st = setup(g, width, height, cull_backfaces=cfg["cull_backfaces"])
    _, ids = visibility(st, width, height, block)
    return surface(scene, g, st, ids, shading=cfg["shading"], dtype=dtype,
                   perspective=cfg["perspective_correct"])


def train_steps(surfaces, targets, tex0, lr, steps, h, w,
                mode=("bilinear", "repeat")):
    """``steps`` SGD steps of the texels on the mean squared error over
    every channel of every pixel of the frames, the texture sampled with
    ``mode`` (filter, wrap): (losses, texels after each step)."""
    tex = tex0.detach().clone()
    losses, texs = [], []
    denom = len(surfaces) * h * w * 4
    for _ in range(steps):
        leaf = tex.detach().requires_grad_(True)
        loss = sum(((shade(s, leaf, h, w, *mode) - tg) ** 2).sum()
                   for s, tg in zip(surfaces, targets)) / denom
        grad, = torch.autograd.grad(loss, leaf)
        losses.append(float(loss.detach()))
        tex = (tex - lr * grad).detach()
        texs.append(tex)
    return losses, texs
