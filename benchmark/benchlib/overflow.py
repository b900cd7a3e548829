"""The program's overflow rule, frozen: which triangles a frame's bin
build sends to the overflow path, and what that path has to do for them.

A copy of the rule of the port's ops/binning.py ``build_bins``, with the
arguments its ``render`` passes (whole-frame bins of 128 x 64 pixels,
split into 4 bands of 16 rows from 2,048 triangles up; at most 12 tiles'
bins a triangle; a pair budget of 0.85 T, or 3.0 T without backface
culling, rounded up to 128), and of ops/setup.py ``coverage_safe``,
computed from the reference's setup (benchlib/reference.py), whose
rounded corners, edge functions, bboxes and validity are the program's
(coverage and depth are compared exact). Kept here so that a change to
the program cannot move the yardstick; benchmark/tests/test_bench_spill.py
holds it against the program's overflow mask.

A valid triangle spills when it is not coverage-safe (``unsafe``), when
it is safe and its bbox spans more than kmax (tile, band) bins
(``kmax``), or when the running sum of the bins of the triangles before
it that passed both tests, its own included, passes the budget
(``budget``).
"""

from __future__ import annotations

import dataclasses

import torch

from . import reference as ref

TILE_W, TILE_H = 128, 64
CHUNK = 128
BANDS, BANDS_MIN_T = 4, 2048
KMAX_TILES = 12
BUDGET = {True: 0.85, False: 3.0}        # by cull_backfaces
# coverage_safe's bounds (the JAX package's ops/setup.py derives them).
EXACT_LIMIT = 2.0 ** 21
ERR_SCALE = 2.0 ** -20
SAFE_MARGIN = 0.25


def coverage_safe(g: ref.Geometry, st: ref.Setup, width, height):
    """[T'] bool: float32 coverage provably inside the bbox, or the
    triangle invalid."""
    tiny = 1e-30
    (x1, x2, x3), (y1, y2, y3) = g.x.unbind(1), g.y.unbind(1)
    a0, b0, a1, b1 = st.a0, st.b0, st.a1, st.b1
    ax = torch.clamp(torch.abs(x3), min=float(width)) + 1.0
    ay = torch.clamp(torch.abs(y3), min=float(height)) + 1.0
    m0 = torch.abs(a0) * ax + torch.abs(b0) * ay
    m1 = torch.abs(a1) * ax + torch.abs(b1) * ay
    md = (torch.abs(x1 - x3) * torch.abs(y2 - y3)
          + torch.abs(x2 - x3) * torch.abs(y1 - y3))
    exact = (m0 + m1 + md) < EXACT_LIMIT
    err0 = torch.where(exact, 0.0, m0 * ERR_SCALE)
    err1 = torch.where(exact, 0.0, m1 * ERR_SCALE)
    err2 = err0 + err1 + torch.where(exact, 0.0, md * ERR_SCALE)
    a2, b2 = a0 + a1, b0 + b1
    g0u = torch.abs(a0) + torch.abs(b0)
    g1u = torch.abs(a1) + torch.abs(b1)
    g2u = torch.abs(a2) + torch.abs(b2)
    g0l = torch.clamp(torch.maximum(torch.abs(a0), torch.abs(b0)), min=tiny)
    g1l = torch.clamp(torch.maximum(torch.abs(a1), torch.abs(b1)), min=tiny)
    g2l = torch.clamp(torch.maximum(torch.abs(a2), torch.abs(b2)), min=tiny)
    e_shift = torch.maximum(torch.maximum(err0 / g0l, err1 / g1l),
                            err2 / g2l)
    dd = torch.clamp(st.abs_d, min=tiny)
    v_shift = torch.maximum(
        torch.maximum(err0 * g1u + err1 * g0u, err0 * g2u + err2 * g0u),
        err1 * g2u + err2 * g1u) / dd
    return ((e_shift <= SAFE_MARGIN) & (v_shift <= SAFE_MARGIN)) | ~st.valid


def reasons(g: ref.Geometry, st: ref.Setup, width, height, *,
            cull_backfaces=True) -> dict:
    """The spilled triangles of a frame by reason: {"budget", "kmax",
    "unsafe"} -> [T'] bool, disjoint."""
    t = st.valid.shape[0]
    bands = BANDS if t >= BANDS_MIN_T else 1
    kmax = KMAX_TILES * bands
    bh = TILE_H // bands
    nb = -(-height // TILE_H) * bands
    bx0, by0, bx1, by1 = st.box.unbind(1)
    ty0 = torch.clamp(by0 // bh, 0, nb - 1)
    ty1 = torch.clamp(by1 // bh, 0, nb - 1)
    nspan = (bx1 // TILE_W - bx0 // TILE_W + 1) * (ty1 - ty0 + 1)
    safe = coverage_safe(g, st, width, height)
    small = st.valid & safe & (nspan <= kmax)
    budget = -(-int(BUDGET[cull_backfaces] * max(t, 1)) // CHUNK) * CHUNK
    cum = torch.cumsum(torch.where(small, nspan, 0), 0)
    return {"budget": small & (cum > budget),
            "kmax": st.valid & safe & (nspan > kmax),
            "unsafe": st.valid & ~safe}


def work(scene, transform, cfg) -> dict:
    """What the overflow path needs of one frame, from the inputs: the
    spilled triangles by reason, the pixels they win among themselves
    (``pixels``) and their covering (pixel centre, triangle) pairs."""
    width, height = cfg["width"], cfg["height"]
    g = ref.geometry(scene["positions"], scene["indices"], transform, width,
                     height, clip_near=cfg["clip_near"])
    st = ref.setup(g, width, height, cull_backfaces=cfg["cull_backfaces"])
    why = reasons(g, st, width, height, cull_backfaces=cfg["cull_backfaces"])
    spilled = why["budget"] | why["kmax"] | why["unsafe"]
    pairs = [0]

    def on_block(t, inside):
        pairs[0] += int(inside.sum())

    _, ids = ref.visibility(dataclasses.replace(st, valid=spilled), width,
                            height, on_block=on_block)
    return dict({k: int(v.sum()) for k, v in why.items()},
                spilled=int(spilled.sum()), pixels=int((ids >= 0).sum()),
                pairs=pairs[0])
