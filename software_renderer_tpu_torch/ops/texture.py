"""Texture sampling: nearest and bilinear, repeat and clamp addressing.

Bilinear sampling reads one row of a quad table per pixel: row (y, x)
holds the 2x2 texel neighbourhood with the wrap mode baked in. That
sampler is plain torch: in the JAX package it is an XLA stage, not a
Pallas kernel. The fused path's texture tail routes through
:func:`sample_texture_planes_compacted`, which takes the windowed
sampler (ops/texture_kernel.py, K7 on the card) when ``SR_TEX_WINDOWED``
asks for it. The JAX package's cap-ladder compaction and its
``TEX_GATHER_SPLIT``/``TEX_TABLE_PACK`` knobs work around the TPU's
static grid and gather costs and are not ported; the JAX docstring states
the compacted sampler equals :func:`sample_texture_planes` per covered
pixel. The trilinear filter is ROADMAP.md Queue 1 item 5.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from ..device import or_default
from .texture_kernel import (LANES, sample_segments_windowed, windowed_count,
                             windowed_prep, windowed_supported,
                             windowed_texels)

# Width of the row segments the texture tail samples in (JAX texture.py).
COMPACT_SEG = LANES

# The texture tail's sampler route, read from SR_TEX_WINDOWED as in JAX
# (texture.py:430): "0" the quad-table sampler always; "1" the windowed
# sampler (K7) whenever the texture supports it; "adaptive" the windowed
# sampler on frames whose window count fits TEX_WIN_AVG_BUDGET.
TEX_WINDOWED = os.environ.get("SR_TEX_WINDOWED", "0")

# Adaptive budget: windows per covered segment (SR_TEX_WIN_AVG, JAX
# texture.py:437).
TEX_WIN_AVG_BUDGET = float(os.environ.get("SR_TEX_WIN_AVG", "4"))


@dataclasses.dataclass
class Texture:
    """An RGB(A) texture. data: [Th, Tw, C] float32 in [0, 1].

    ``table`` is the bilinear quad table and ``texels`` the windowed
    sampler's texel table (ops/texture_kernel.py ``windowed_texels``, for
    C <= 4), each built once at construction from ``data``, so gradients
    reach ``data`` through them.
    """

    data: torch.Tensor
    filter: str = "bilinear"   # "nearest" | "bilinear"
    wrap: str = "repeat"       # "repeat" | "clamp"
    table: Optional[torch.Tensor] = None
    texels: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.filter not in ("nearest", "bilinear"):
            raise NotImplementedError(
                f"texture filter {self.filter!r} is not ported yet "
                "(ROADMAP.md Queue 1 item 5)")
        if self.filter == "bilinear":
            if self.table is None:
                self.table = _quad_table_from(self.data, self.wrap)
            if self.texels is None and self.data.shape[-1] <= 4:
                self.texels = windowed_texels(self.data, self.wrap)

    def to(self, device) -> "Texture":
        mv = lambda t: None if t is None else t.to(device)
        return Texture(self.data.to(device), self.filter, self.wrap,
                       mv(self.table), mv(self.texels))


def _wrap_coords(i, n: int, mode: str):
    if mode == "repeat":
        return torch.remainder(i, n)
    if mode == "clamp":
        return torch.clamp(i, 0, n - 1)
    raise ValueError(f"unknown wrap mode {mode!r}")


def _quad_table_from(d, wrap: str):
    """[Th*Tw, 4C] rows [t(y,x), t(y,x+1), t(y+1,x), t(y+1,x+1)]."""
    if wrap == "repeat":
        dx = torch.roll(d, -1, dims=1)
        dy = torch.roll(d, -1, dims=0)
        dxy = torch.roll(dx, -1, dims=0)
    elif wrap == "clamp":
        dx = torch.cat([d[:, 1:], d[:, -1:]], dim=1)
        dy = torch.cat([d[1:], d[-1:]], dim=0)
        dxy = torch.cat([dx[1:], dx[-1:]], dim=0)
    else:
        raise ValueError(f"unknown wrap mode {wrap!r}")
    th, tw, c = d.shape
    return torch.cat([d, dx, dy, dxy], dim=-1).reshape(th * tw, 4 * c)


def sample_texture_planes(tex: Texture, u, v):
    """Sample at (u, v) planes in [0, 1] (u right, v down); returns a list
    of C planes shaped like u."""
    th, tw, c = tex.data.shape
    u = u * tw
    v = v * th
    if tex.filter == "nearest":
        xi = _wrap_coords(torch.floor(u).to(torch.int32), tw, tex.wrap)
        yi = _wrap_coords(torch.floor(v).to(torch.int32), th, tex.wrap)
        texel = tex.data.reshape(th * tw, c)[(yi * tw + xi).long()]
        return [texel[..., i] for i in range(c)]
    x = u - 0.5
    y = v - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xa = _wrap_coords(x0.to(torch.int32), tw, tex.wrap)
    ya = _wrap_coords(y0.to(torch.int32), th, tex.wrap)
    quad = tex.table[(ya * tw + xa).long()]
    out = []
    for i in range(c):
        t00 = quad[..., i]
        t01 = quad[..., c + i]
        t10 = quad[..., 2 * c + i]
        t11 = quad[..., 3 * c + i]
        top = t00 + (t01 - t00) * fx
        bot = t10 + (t11 - t10) * fx
        out.append(top + (bot - top) * fy)
    return out


def sample_texture_planes_compacted(tex: Texture, u, v, covered):
    """The fused path's bilinear texture tail: C planes [H, W] sampled at
    the (u, v) planes, routed by :data:`TEX_WINDOWED`. Per covered pixel
    every route equals :func:`sample_texture_planes`; uncovered pixels
    hold values the caller's covered mask zeroes.

    * ``"0"``, a filter other than bilinear, a texture
      :func:`windowed_supported` refuses, or a width that is not a
      multiple of COMPACT_SEG: the quad-table sampler over the whole
      frame.
    * ``"1"``: :func:`windowed_prep` and the windowed sampler over every
      1 x COMPACT_SEG row segment of the frame, as JAX's ``win_full``
      (texture.py:796-817). JAX's cap ladder of compacted tiers is not
      ported: it sizes the TPU's static grid, while on the card a segment
      with ``nwin = 0`` costs one early exit, and per covered pixel the
      values are the same either way.
    * ``"adaptive"``: the windowed sampler when the frame's total
      :func:`windowed_count` is at most TEX_WIN_AVG_BUDGET times its
      covered segments (JAX's tier rule, with the tier's cap replaced by
      the count it bounds), else the quad-table sampler. Reading the
      predicate costs one host sync per frame.

    u, v, covered: [H, W].
    """
    th, tw, c = tex.data.shape
    h, w = u.shape
    k = COMPACT_SEG
    ns = h * w // k
    mode = TEX_WINDOWED
    if mode not in ("0", "1", "adaptive"):
        raise ValueError(f"SR_TEX_WINDOWED must be '0', '1' or 'adaptive', "
                         f"got {mode!r}")
    if (mode == "0" or tex.filter != "bilinear" or w % k
            or not windowed_supported(th, tw, c, k)):
        return sample_texture_planes(tex, u, v)
    u_s, v_s = u.reshape(ns, k), v.reshape(ns, k)
    cov_s = covered.reshape(ns, k)
    if mode == "adaptive":
        total = windowed_count(v_s, cov_s, th=th, wrap=tex.wrap).sum()
        n_cov = cov_s.any(dim=1).sum()
        if not bool(total <= TEX_WIN_AVG_BUDGET * n_cov):   # host sync
            return sample_texture_planes(tex, u, v)
    xa, dy, fx, fy, y0, nwin = windowed_prep(u_s, v_s, cov_s, th=th, tw=tw,
                                             wrap=tex.wrap)
    planes = sample_segments_windowed(tex.texels, xa, dy, fx, fy, y0, nwin,
                                      c=c, th=th, tw=tw, wrap=tex.wrap)
    return [p.reshape(h, w) for p in planes.unbind(0)]


def sample_texture(tex: Texture, uv):
    """Sample at ``uv`` [..., 2] in [0, 1] (u right, v down); returns
    [..., C]. The planes sampler on the two coordinate planes (the same
    arithmetic as the JAX package's ``sample_texture``)."""
    return torch.stack(sample_texture_planes(tex, uv[..., 0], uv[..., 1]),
                       dim=-1)


def checkerboard(size: int = 256, tiles: int = 8, c0=(1.0, 1.0, 1.0),
                 c1=(0.2, 0.2, 0.2), device=None) -> Texture:
    """Procedural checkerboard (test/demo texture), on the card unless
    ``device`` says otherwise (device.py)."""
    device = or_default(device)
    ij = torch.arange(size, device=device) * tiles // size
    mask = (ij[:, None] + ij[None, :]) % 2
    c0 = torch.tensor(c0, dtype=torch.float32, device=device)
    c1 = torch.tensor(c1, dtype=torch.float32, device=device)
    return Texture(data=torch.where(mask[..., None] == 0, c0, c1))
