"""Texture sampling: nearest, bilinear and trilinear (mipmapped), repeat
and clamp addressing.

Bilinear sampling reads one row of a quad table per pixel: row (y, x)
holds the 2x2 texel neighbourhood with the wrap mode baked in. That
sampler is plain torch here: in the JAX package it is an XLA stage, not
a Pallas kernel. On the card the fused path's texture tail samples the
quad table inside one kernel with its combine (csrc/tail.cu,
ops/shading.py ``texture_tail``) on every frame that needs no gradient
on route "0"; training frames, the other filters and the other routes
take :func:`sample_texture_planes_compacted` in torch, which takes the
windowed sampler (ops/texture_kernel.py, K7 on the card) when
``SR_TEX_WINDOWED`` asks for it. The JAX package's cap-ladder compaction and its
``TEX_GATHER_SPLIT``/``TEX_TABLE_PACK`` knobs work around the TPU's
static grid and gather costs and are not ported; the JAX docstring states
the compacted sampler equals :func:`sample_texture_planes` per covered
pixel.

Trilinear sampling reads a mip pyramid held as one quad table, level 0
first (rows [0, Th*Tw) are the bilinear table): per pixel the level
comes from screen-space finite differences of the uv planes, and two
row gathers (the floor and the next level) are blended. Like bilinear it
is plain torch; the JAX package's cap-ladder compaction of it is TPU
economics and is not ported, so the fused path's trilinear tail samples
the whole frame.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from ..device import or_default
from .texture_kernel import (LANES, count_windows, sample_segments_windowed,
                             windowed_count, windowed_prep,
                             windowed_supported, windowed_texels)

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

    ``table`` is the bilinear quad table (for ``trilinear``, the mip
    pyramid's quad table, level 0 first) and ``texels`` the windowed
    sampler's texel table (ops/texture_kernel.py ``windowed_texels``,
    bilinear with C <= 4), each built once at construction from ``data``,
    so gradients reach ``data`` through them.
    """

    data: torch.Tensor
    filter: str = "bilinear"   # "nearest" | "bilinear" | "trilinear"
    wrap: str = "repeat"       # "repeat" | "clamp"
    table: Optional[torch.Tensor] = None
    texels: Optional[torch.Tensor] = None

    def __post_init__(self):
        if self.filter not in ("nearest", "bilinear", "trilinear"):
            raise ValueError(f"unknown filter {self.filter!r}")
        if self.filter == "trilinear" and self.table is None:
            self.table = _mip_table_from(self.data, self.wrap)
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
    if tex.filter == "trilinear":
        return sample_texture_planes_trilinear(tex, u, v)
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

    A frame that takes the windowed sampler adds its window counts to its
    device's window counter (ops/texture_kernel.py ``window_counts``).

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
    count_windows(cov_s, nwin)
    planes = sample_segments_windowed(tex.texels, xa, dy, fx, fy, y0, nwin,
                                      c=c, th=th, tw=tw, wrap=tex.wrap)
    return [p.reshape(h, w) for p in planes.unbind(0)]


# ---------------------------------------------------------------------------
# Mipmapped (trilinear) filtering: the JAX package's texture.py:207-345.
# ---------------------------------------------------------------------------

def _num_mip_levels(th: int, tw: int) -> int:
    """Level 0 plus one per 2x box step while both sides stay even (an
    odd side leaves one level: trilinear is then bilinear)."""
    n = 1
    while th % 2 == 0 and tw % 2 == 0 and min(th, tw) > 1:
        th //= 2
        tw //= 2
        n += 1
    return n


def _mip_offsets(th: int, tw: int, n: int):
    """Row offset of each level's quad table in the pyramid table."""
    offs = [0]
    for lev in range(1, n):
        offs.append(offs[-1] + (th >> (lev - 1)) * (tw >> (lev - 1)))
    return offs


def _mip_chain(data):
    """[level 0 = data, level 1, ...] by exact 2x2 box averaging."""
    levels = [data]
    d = data
    while (d.shape[0] % 2 == 0 and d.shape[1] % 2 == 0
           and min(d.shape[0], d.shape[1]) > 1):
        d = 0.25 * (d[0::2, 0::2] + d[1::2, 0::2]
                    + d[0::2, 1::2] + d[1::2, 1::2])
        levels.append(d)
    return levels


def _mip_table_from(data, wrap: str):
    """The pyramid: every level's quad table, level 0 first."""
    return torch.cat([_quad_table_from(d, wrap) for d in _mip_chain(data)],
                     dim=0)


def _lod_rho2(u, v, th: int, tw: int):
    """Squared largest texel-space footprint per pixel of the [H, W] uv
    planes: forward differences, the last column (row) repeating its
    neighbour's."""
    def fdiff(a, dim):
        d = torch.diff(a, dim=dim)
        edge = d[:, -1:] if dim == 1 else d[-1:, :]
        return torch.cat([d, edge], dim=dim)

    def sq(x):
        return x * x

    rx2 = sq(fdiff(u, 1) * tw) + sq(fdiff(v, 1) * th)
    ry2 = sq(fdiff(u, 0) * tw) + sq(fdiff(v, 0) * th)
    return torch.clamp(torch.maximum(rx2, ry2), min=2.0 ** -64)


def screen_lod(u, v, th: int, tw: int):
    """Per-pixel mip level of the [H, W] uv planes: log2 of the largest
    texel-space footprint (unclamped; the sampler clamps). As with a
    GPU's quad derivatives, differences straddle triangle edges and a
    repeat seam reads as a huge footprint."""
    return 0.5 * torch.log2(_lod_rho2(u, v, th, tw))


def _tri_level_sample(table, offs, c: int, th: int, tw: int, wrap: str,
                      u, v, lev):
    """Bilinear sample of mip level ``lev`` (per-pixel int32) from the
    pyramid ``table``: one row gather, the level folded into the row
    index. Returns C planes shaped like u."""
    tw_l = torch.bitwise_right_shift(tw, lev)
    th_l = torch.bitwise_right_shift(th, lev)
    x = u * tw_l.to(torch.float32) - 0.5
    y = v * th_l.to(torch.float32) - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    xi = x0.to(torch.int32)
    yi = y0.to(torch.int32)
    if wrap == "repeat":
        xa = torch.remainder(xi, tw_l)
        ya = torch.remainder(yi, th_l)
    elif wrap == "clamp":
        xa = torch.minimum(torch.clamp(xi, min=0), tw_l - 1)
        ya = torch.minimum(torch.clamp(yi, min=0), th_l - 1)
    else:
        raise ValueError(f"unknown wrap mode {wrap!r}")
    quad = table[(offs[lev.long()] + ya * tw_l + xa).long()]
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


def sample_texture_planes_trilinear(tex: Texture, u, v, lod=None):
    """Trilinear sample of the [H, W] uv planes; returns C [H, W] planes.

    lod: per-pixel mip level (anything broadcastable to u); by default
    :func:`screen_lod` of the planes. At an integer lod k the result is
    the bilinear sample of level k (the blend adds (b - a) * 0).
    """
    th, tw, c = tex.data.shape
    n = _num_mip_levels(th, tw)
    if lod is None:
        lod = screen_lod(u, v, th, tw)
    lod = torch.as_tensor(lod, dtype=torch.float32, device=u.device)
    lod = torch.clamp(torch.broadcast_to(lod, u.shape), 0.0, float(n - 1))
    l0 = torch.floor(lod).to(torch.int32)
    lf = lod - l0.to(torch.float32)
    l1 = torch.clamp(l0 + 1, max=n - 1)
    table = tex.table
    # Filled slice by slice: no host-to-card copy, so a CUDA graph can
    # capture the sampler.
    offs = torch.zeros(n, dtype=torch.int32, device=u.device)
    for i, o in enumerate(_mip_offsets(th, tw, n)[1:], start=1):
        offs[i:i + 1] = o
    lo = _tri_level_sample(table, offs, c, th, tw, tex.wrap, u, v, l0)
    hi = _tri_level_sample(table, offs, c, th, tw, tex.wrap, u, v, l1)
    return [a + (b - a) * lf for a, b in zip(lo, hi)]


def sample_texture_planes_trilinear_compacted(tex: Texture, u, v, covered):
    """The fused path's trilinear texture tail: C planes [H, W].

    JAX samples only the covered 1 x COMPACT_SEG row segments through a
    ladder of static caps (its compiled grid's economics); here the whole
    frame is sampled, as the bilinear mode "0" does, which equals
    :func:`sample_texture_planes_trilinear` on every pixel, covered or
    not (``covered`` is accepted for the same signature).
    """
    del covered
    return sample_texture_planes_trilinear(tex, u, v)


def sample_texture(tex: Texture, uv):
    """Sample at ``uv`` [..., 2] in [0, 1] (u right, v down); returns
    [..., C]. The planes sampler on the two coordinate planes (the same
    arithmetic as the JAX package's ``sample_texture``). Trilinear needs
    [H, W, 2] uv grids: its level comes from differences across pixels.
    """
    if tex.filter == "trilinear" and uv.dim() != 3:
        raise ValueError(
            "trilinear sampling needs [H, W, 2] uv grids (the level comes "
            "from finite differences of the planes); use "
            "sample_texture_planes_trilinear with an explicit lod for uv "
            "lists")
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
