"""The program's window rule, frozen: how the windowed sampler (K7)
walks a frame's 1 x 128 row segments, and what K7 has to move for it.

A copy of the rule of the port's ops/texture_kernel.py ``windowed_prep``
(routes "1" and "adaptive"): each covered lane's texel row is the
bilinear sampler's, ``floor(v * th - 0.5)`` wrapped by ``repeat`` or
clamped by ``clamp``; a segment's covered lanes occupy 8-row slabs of
the texture; its windows, 8 rows each at 8-aligned starts, walk
circularly over the slabs from an occupied one, in the fewest windows
that reach every occupied slab (``nwin``, 0 with no covered lane), from
the first occupied slab that needs that few (``y0`` = 8 x that slab; 0
with no covered lane). Written apart from the program's cummax: here
each occupied slab's gap, the empty slabs just before it circularly, is
found shift by shift, and the walk starts after the widest gap, taking
``S - gap`` windows of the ``S = th / 8`` slabs.

Kept here so that a change to the program cannot move the yardstick;
benchmark/tests/test_bench_windowed.py holds it against the program's
``windowed_prep``. Applied to the reference's uv planes and covered
pixels (benchlib/reference.py ``frame_surface``), whose texel rows are
the program's up to rounding.
"""

from __future__ import annotations

import torch

from . import reference as ref

# Rows of a window; wrap-padded rows below the texel table; lanes of a
# segment.
WIN_STRIDE = 8
WINH = 16
LANES = 128


def texel_rows(v, th: int, wrap: str):
    """Integer texel row of each lane's bilinear corner (int32)."""
    y0 = torch.floor(v * th - 0.5).to(torch.int32)
    if wrap == "repeat":
        return torch.remainder(y0, th)
    if wrap == "clamp":
        return torch.clamp(y0, 0, th - 1)
    raise ValueError(f"unknown wrap {wrap!r}")


def windows(v, cov, th: int, wrap: str):
    """(y0, nwin), [cap] int32 each, of segments with [cap, 128] v planes
    and covered masks ``cov``."""
    cap = v.shape[0]
    s = th // WIN_STRIDE
    slab = texel_rows(v, th, wrap).long() // WIN_STRIDE
    seg = torch.arange(cap, device=v.device)[:, None].expand_as(slab)
    occ = torch.zeros((cap, s), dtype=torch.bool, device=v.device)
    occ[seg[cov], slab[cov]] = True
    # gap[:, i]: the empty slabs just before slab i, circularly; S - 1
    # for a slab alone.
    gap = torch.full((cap, s), -1, dtype=torch.int64, device=v.device)
    for k in range(1, s + 1):
        before = torch.roll(occ, k, dims=1)      # before[:, i] = occ[:, i-k]
        gap = torch.where((gap < 0) & before, k - 1, gap)
    gap = torch.where(occ, gap, -1)
    widest = gap.max(dim=1).values
    idx = torch.arange(s, device=v.device).expand(cap, s)
    base = torch.where(gap == widest[:, None], idx, s).min(dim=1).values
    any_occ = occ.any(dim=1)
    nwin = torch.where(any_occ, s - widest, 0)
    y0 = torch.where(any_occ, base * WIN_STRIDE, 0)
    return y0.to(torch.int32), nwin.to(torch.int32)


def work(scene, transform, cfg) -> dict:
    """What K7 needs of one frame, from the inputs: the frame's
    ``segments``, those with a window (``window_segments``), their
    ``windows``, the covered ``lanes`` (each lies inside its segment's
    windows), and the texture's shape (``th``, ``tw``, ``c``)."""
    width, height = cfg["width"], cfg["height"]
    if width % LANES:
        raise ValueError(f"the windowed sampler takes frames of a width "
                         f"that is a multiple of {LANES}, not {width}")
    th, tw, c = scene["texture"].shape
    surf = ref.frame_surface(scene, transform, cfg)
    dev = surf.pix.device
    v = torch.zeros(height * width, dtype=torch.float32, device=dev)
    cov = torch.zeros(height * width, dtype=torch.bool, device=dev)
    v[surf.pix] = surf.v.float()
    cov[surf.pix] = True
    _, nwin = windows(v.reshape(-1, LANES), cov.reshape(-1, LANES), th,
                      cfg["texture"]["wrap"])
    return dict(segments=nwin.shape[0], window_segments=int((nwin > 0).sum()),
                windows=int(nwin.sum()), lanes=int(cov.sum()), th=th, tw=tw,
                c=c)
