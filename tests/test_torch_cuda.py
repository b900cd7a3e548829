"""PyTorch port on the card: the one place that checks it is right there.
Each CUDA kernel against its plain version on the same CUDA inputs, and
each route's frames against the CPU's, against each other and free of
host syncs, at small sizes (config 4 at full size where the size is the
point). A kernel's time against its least time is chip_smoke.py's, and
end-to-end times are the benchmark's. Every test carries the ``cuda``
marker and skips without a GPU.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Ids and depth must be bit-equal (the kernels are built with --fmad=false
and IEEE division/sqrt, and repeat the plain versions' operations in
order); shaded planes within 1e-5 (powf may differ from torch.pow by an
ulp or two). The windowed sampler (K7), the gather probe (K8) and the
texture tail kernel equal their plain versions bit for bit.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from software_renderer_tpu_torch import _cuda, render
from software_renderer_tpu_torch.models import scenes
from software_renderer_tpu_torch.models.mesh import mesh_from_numpy
from software_renderer_tpu_torch.ops import binning as tb
from software_renderer_tpu_torch.ops import frontend as fe
from software_renderer_tpu_torch.ops import shading as tsh
from software_renderer_tpu_torch.ops import texture as ttex
from software_renderer_tpu_torch.ops import texture_kernel as ttk
from software_renderer_tpu_torch.ops import transforms as tf
from software_renderer_tpu_torch.ops.frontend_kernel import (
    fe_kernel, fe_plain, fe_table_kernel, fe_table_plain)
from software_renderer_tpu_torch.ops.rasterize_kernel import (
    _poison_row, visibility_kernel, visibility_merge_kernel,
    visibility_merge_plain, visibility_plain)
from software_renderer_tpu_torch.ops.shading import Light, shading_params
from software_renderer_tpu_torch.parallel.batch import render_batch
from software_renderer_tpu_torch.parallel.sharding import texture_train_step
from software_renderer_tpu_torch.render import (RenderPass, clip_front,
                                               clip_inputs,
                                               planar_front_table_of,
                                               shading_inputs,
                                               triangle_inputs)
from software_renderer_tpu_torch.tools import probe_dyngather as probe

PLANE_TOL = 1e-5

# The string condition is evaluated when each test is set up, not at
# import, so every pytest worker collects the same tests.
pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs an NVIDIA GPU")]


def _equal(a, b):
    same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
        if a.is_floating_point() else (a == b)
    return bool(same.all())


@pytest.mark.parametrize("cull", [False, True])
def test_fe_kernel_matches_plain(cull):
    g = torch.Generator().manual_seed(9)
    cols = (torch.rand((9, 5000), generator=g) * 2.4 - 1.2).cuda()
    cols[2::3] += 1.0  # z in (-0.2, 2.2): some corners behind the eye
    m = torch.eye(4)
    m[3, 2] = 1.0
    m16 = m.reshape(16).cuda()
    k = fe_kernel(cols, m16, 1920, 1080, cull_backfaces=cull)
    p = fe_plain(cols, m16, 1920, 1080, cull_backfaces=cull)
    torch.cuda.synchronize()
    assert _equal(k, p), [fe.FE_ROWS[i] for i in range(24)
                          if not _equal(k[i], p[i])]


def _fe_table_case(t, n_chan, seed=9):
    """[9, t] corner rows and [3 n_chan, t] attribute rows on the card,
    with triangles 0-3 degenerate, offscreen, behind the near plane and
    with a NaN corner (w = z + 1), and a NaN attribute on triangle 4."""
    g = torch.Generator().manual_seed(seed)
    cols = torch.rand((9, t), generator=g) * 2.4 - 1.2
    cols[2::3] += 1.0  # z in (-0.2, 2.2): some corners behind the eye
    cols[:, 0] = cols[:3, 0].repeat(3)           # three equal corners
    cols[0::3, 1] = 5.0                           # x far right of the frame
    cols[2::3, 2] = -1.5                          # w = -0.5 at every corner
    cols[4, 3] = float("nan")
    cols[:, 4] = torch.tensor([-0.5, -0.5, 0.5, 0.5, 0.5, 0.5, 0.5, -0.5,
                               0.5])              # a valid, front-facing one
    attrs = torch.rand((3 * n_chan, t), generator=g) * 2.0 - 1.0
    if n_chan:
        attrs[3 * n_chan - 2, 4] = float("nan")
    m = torch.eye(4)
    m[3, 2] = 1.0
    return cols.cuda(), m.reshape(16).cuda(), attrs.cuda()


@pytest.mark.parametrize("t", [5000, 77])
@pytest.mark.parametrize("n_chan", [0, 2, 8, 9])
@pytest.mark.parametrize("cull", [False, True])
def test_fe_table_kernel_matches_plain(cull, n_chan, t):
    """K1 with the stream table: rows and table bit-equal to the plain
    composition; invalid triangles (degenerate, offscreen, behind the
    near plane, NaN corner) get the poison row; a NaN attribute of a valid
    triangle gives the plain version's NaN planes."""
    cols, m16, attrs = _fe_table_case(t, n_chan)
    _cuda.reset_launches()
    rows, table = fe_table_kernel(cols, m16, attrs, 1920, 1080,
                                  cull_backfaces=cull)
    assert _cuda.launches["fe"] == 1
    p_rows, p_table = fe_table_plain(cols, m16, attrs, 1920, 1080,
                                     cull_backfaces=cull)
    torch.cuda.synchronize()
    assert table.shape == (t, 11 + 3 * n_chan)
    assert _equal(rows, p_rows), [fe.FE_ROWS[i] for i in range(24)
                                  if not _equal(rows[i], p_rows[i])]
    assert _equal(table, p_table)
    assert _equal(rows, fe_kernel(cols, m16, 1920, 1080,
                                  cull_backfaces=cull))
    valid = rows[fe.FE_ROWS.index("valid")] != 0
    assert not bool(valid[:4].any()) and bool(valid[4])
    assert 0 < int(valid.sum()) < t
    poison = fe._stream_poison(11 + 3 * n_chan, "cuda")
    assert _equal(table[~valid], poison.expand(int((~valid).sum()), -1))
    if n_chan:
        assert bool(torch.isnan(table[4, 11 + 3 * (n_chan - 1):]).all())
        assert not bool(torch.isnan(table[4, :11 + 3 * (n_chan - 1)]).any())


def test_planar_front_table_feeds_the_pipeline():
    """render's main path through planar_front_table gives the frame of
    fused_pipeline building its own table."""
    rp = scenes.config4_many_objects(0.0, width=320, height=192,
                                     triangles=3000, device="cuda")
    ps, chans, attrs, prm, lit, tex = triangle_inputs(rp)
    kw = dict(width=320, height=192, chans=chans, has_light=lit,
              has_texture=tex, pair_budget_factor=0.85)
    tris = rp.mesh.triangles().long()
    ps2, *table = fe.planar_front_table(
        fe.corner_cols(rp.mesh.positions[tris]), rp.transform, attrs, 320,
        192, cull_backfaces=True)
    want = tb.fused_pipeline(ps, attrs, prm, **kw)
    got = tb.fused_pipeline(ps2, None, prm, stream_table=table, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _equal(a, b)


@pytest.mark.parametrize("bands", [1, 4])
def test_fused_and_overflow_kernels_match_plain(bands):
    rp = scenes.config4_many_objects(0.0, width=320, height=192,
                                     triangles=3000, device="cuda")
    ps, chans, attrs, prm, _, _ = triangle_inputs(rp)
    w, h = rp.width, rp.height
    table, a, poison = fe.stream_table_planar(
        ps, fe.attribute_plane_cols(ps, attrs))
    info = tb.build_bins(ps, width=w, height=h, kmax=1, bands=bands)
    assert info.n_overflow > 0
    rows = tb.gather_stream(table, info.ids, poison).contiguous()
    ov = torch.nonzero(info.overflow_mask).squeeze(1).to(torch.int32)
    rec = tb.gather_stream(fe.pack_records_planar(ps, 128), ov,
                           _poison_row("cuda")).contiguous()
    z0 = torch.full((h, w), float("inf"), device="cuda")
    i0 = torch.full((h, w), -1, dtype=torch.int32, device="cuda")
    zk, ik = visibility_merge_kernel(rec, z0, i0, width=w, height=h)
    zp, ip = visibility_merge_plain(rec, z0, i0, width=w, height=h)
    torch.cuda.synchronize()
    assert _equal(ik, ip) and _equal(zk, zp)
    ov_rows = tb.gather_stream(table, ov, poison).contiguous()
    g0 = torch.zeros((a, h, w), device="cuda")
    gk = tb.resolve_merge_kernel(ov_rows, ik, g0, width=w, height=h)
    gp = tb.resolve_merge_plain(ov_rows, ik, g0, width=w, height=h)
    torch.cuda.synchronize()
    assert float((gk - gp).abs().max()) <= PLANE_TOL
    kw = dict(width=w, height=h, chans=chans, has_light=True,
              has_texture=True, bands=bands, bbox=fe.bbox_table(ps))
    for seeds in (None, (zk, ik, gk)):
        zk2, ik2, ok2 = tb.fused_kernel(rows, info.bin_start, prm,
                                        seeds=seeds, **kw)
        zp2, ip2, op2 = tb.fused_plain(rows, info.bin_start, prm,
                                       seeds=seeds, **kw)
        torch.cuda.synchronize()
        assert _equal(ik2, ip2) and _equal(zk2, zp2)
        assert float((ok2 - op2).abs().max()) <= PLANE_TOL


@pytest.mark.parametrize("bands", [1, 4])
def test_backend_kernels_match_plain(bands, monkeypatch):
    """K3' (clear mode), K5 and K6 against their plain versions; the
    unbinned record walk against the binned pass (K5, then K3 and K4 on
    the kmax=1 spill) and the fused path (K2 seeded from K3 and K4 on the
    same spill) bit for bit in depth and id; binned_pipeline's G-buffer
    equal to K6's planes with the plain K4 applied in place on the inputs
    of its own K4 call."""
    rp = scenes.config4_many_objects(0.0, width=320, height=192,
                                     triangles=3000, device="cuda")
    ps, chans, attrs, prm, lit, tex = triangle_inputs(rp)
    w, h = rp.width, rp.height
    geo = dict(width=w, height=h, bands=bands)
    info = tb.build_bins(ps, width=w, height=h, bands=bands)
    table, a, poison = fe.stream_table_planar(
        ps, fe.attribute_plane_cols(ps, attrs))
    rows = tb.gather_stream(table, info.ids, poison).contiguous()
    bbox = fe.bbox_table(ps)
    zk, ik = tb.binned_vis_kernel(rows, info.bin_start, bbox=bbox, **geo)
    zp, ip = tb.binned_vis_plain(rows, info.bin_start, bbox=bbox, **geo)
    gk = tb.resolve_kernel(rows, info.bin_start, ik, n_channels=a, **geo)
    gp = tb.resolve_plain(rows, info.bin_start, ik, n_channels=a, **geo)
    rec = fe.pack_records_planar(ps, 128)
    zv, iv = visibility_kernel(rec, width=w, height=h)
    zvp, ivp = visibility_plain(rec, width=w, height=h)
    torch.cuda.synchronize()
    assert bool((ik >= 0).any())
    assert _equal(ik, ip) and _equal(zk, zp)
    assert float((gk - gp).abs().max()) <= PLANE_TOL
    assert _equal(iv, ivp) and _equal(zv, zvp)
    calls = []
    kernel = tb.resolve_merge_kernel

    def record(rows, tid, gb_in, **kw):
        calls.append((rows, tid, gb_in.clone(), dict(kw)))
        return kernel(rows, tid, gb_in, **kw)

    _cuda.reset_launches()
    with monkeypatch.context() as m:
        m.setattr(tb, "resolve_merge_kernel", record)
        d, i, g = tb.binned_pipeline(ps, attrs, width=w, height=h, kmax=1)
    torch.cuda.synchronize()
    for k in ("binned_vis", "visibility_merge", "resolve", "resolve_merge"):
        assert _cuda.launches[k] == 1, _cuda.launches
    assert _equal(i, iv) and _equal(d, zv)
    assert g.shape == (h, w, a) and bool(torch.isfinite(g).all())
    (ov_rows, tid, g6, k4), = calls
    assert k4.pop("inplace"), "binned_pipeline's K4 copies its seed"
    gp = tb.resolve_merge_plain(ov_rows, tid, g6.clone(), inplace=True, **k4)
    d2, i2, _ = tb.fused_pipeline(ps, attrs, prm, width=w, height=h,
                                  chans=chans, has_light=lit,
                                  has_texture=tex, kmax=1, bands=bands)
    torch.cuda.synchronize()
    assert _equal(g.permute(2, 0, 1), gp)
    assert _cuda.launches["fused_seeded"] == 1
    assert _equal(i2, iv) and _equal(d2, zv)


def _px_corners(px, py, z):
    """[n, 3, 3] float32 NDC corners (transform eye(4)) of triangles with
    pixel-coordinate corners (px, py) [n, 3] on the _WALK_W x _WALK_H
    frame, at depth z [n, 3]."""
    return np.stack([px / _WALK_W * 2.0 - 1.0, 1.0 - py / _WALK_H * 2.0, z],
                    -1).astype(np.float32)


# The bin-walk cases' frame: 120 = 64 + 56 rows and 200 = 128 + 72
# columns, so the last tile row and column are ragged.
_WALK_W, _WALK_H = 200, 120
_WALK_CASES = ("long", "one_warp", "edges", "y_start", "ties", "none")


def _walk_case(case, dev="cuda"):
    """(planar setup, attribute columns, height, y_start) of one bin-walk
    case: the setup is for the whole _WALK_W x _WALK_H frame, the walk
    covers its rows [y_start, y_start + height)."""
    rng = np.random.default_rng(30 + _WALK_CASES.index(case))

    def tiny(n, x0, x1, y0, y1):  # corners within 3 pixels of a point
        return (rng.integers(x0, x1, (n, 1)) + rng.integers(0, 4, (n, 3)),
                rng.integers(y0, y1, (n, 1)) + rng.integers(0, 4, (n, 3)))

    h, y0 = _WALK_H, 0
    if case == "long":            # > 2 staged chunks (256) in one bin
        px, py = tiny(700, 0, 125, 0, 13)
    elif case == "one_warp":      # every record in one warp's 16 x 4
        # rectangle: columns 32-47, rows 8-11
        px, py = tiny(900, 32, 45, 8, 9)
    elif case == "edges":
        # Boxes that touch one row or column of a warp rectangle (whose
        # edges are at multiples of 16 columns and 4 rows), boxes at the
        # ragged frame edge, and triangles past every frame edge.
        xe = np.array([0, 15, 16, 31, 32, 63, 64, 127, 128, 159, 160, 191,
                       198])
        ye = np.array([0, 3, 4, 7, 8, 15, 16, 63, 64, 111, 112, 115, 118])
        px = rng.choice(xe, (300, 1)) + rng.integers(0, 2, (300, 3))
        py = rng.choice(ye, (300, 1)) + rng.integers(0, 2, (300, 3))
        px = np.concatenate([px, rng.uniform(-150, 350, (40, 3))])
        py = np.concatenate([py, rng.uniform(-100, 220, (40, 3))])
    elif case == "y_start":       # rows [37, 101) of the frame
        px, py = tiny(500, -2, 200, -2, 120)
        h, y0 = 64, 37
    elif case == "ties":          # one depth everywhere: every overlap is
        # an equal-depth tie, decided by id (lower ids drawn first)
        px, py = tiny(300, 0, 197, 0, 117)
        px = px + rng.integers(0, 12, px.shape)
    else:                         # nothing on screen: no pairs at all
        px, py = tiny(20, 400, 500, 0, 100)
    z = (np.full(px.shape, 0.5) if case == "ties"
         else rng.uniform(0.1, 0.9, px.shape))
    if case == "edges":           # the large triangles behind the small
        z[-40:] = 0.95
    corners = torch.from_numpy(_px_corners(px, py, z)).to(dev)
    ps = fe.planar_front(fe.corner_cols(corners), torch.eye(4, device=dev),
                         _WALK_W, _WALK_H)
    vals = torch.from_numpy(rng.uniform(
        -1.0, 1.0, (corners.shape[0], 3, 8)).astype(np.float32)).to(dev)
    return ps, fe.attr_corner_cols(vals), h, y0


def _walk_inputs(case, bands, dev="cuda"):
    """The bin walk's inputs for a case: (rows, bin_start, bbox, channel
    count, geometry kwargs, planar setup), every safe triangle binned."""
    ps, attrs, h, y0 = _walk_case(case, dev)
    info = tb.build_bins(ps, width=_WALK_W, height=h, y_start=y0,
                         kmax=10_000, pair_budget_factor=1e4, bands=bands)
    table, a, poison = fe.stream_table_planar(
        ps, fe.attribute_plane_cols(ps, attrs))
    rows = tb.gather_stream(table, info.ids, poison).contiguous()
    counts = info.bin_start[1:] - info.bin_start[:-1]
    assert info.n_overflow == 0
    if case == "long":            # ... and empty bins
        assert int(counts.max()) > 512 and bool((counts == 0).any())
    if case == "one_warp":
        assert int(counts.max()) == int(counts.sum()) >= 256
    if case == "none":
        assert int(info.bin_start[-1]) == 0
    geo = dict(width=_WALK_W, height=h, y_start=y0, bands=bands)
    return rows, info.bin_start, fe.bbox_table(ps), a, geo, ps


def _walk_seeds(z, ids, n_tri, a, seed):
    """Seed buffers against a static frame (z, ids): a third of the
    pixels tie its depth with an id one lower or one higher, a sixth are
    +inf with an id (a record that misses the pixel must not take it),
    the rest random; random G-buffer planes."""
    g = torch.Generator(device=z.device).manual_seed(seed)
    rand = lambda: torch.rand(z.shape, generator=g, device=z.device)
    u = rand()
    step = torch.where(rand() < 0.5, -1, 1)
    rnd_id = torch.randint(0, n_tri + 1, z.shape, generator=g,
                           device=z.device)
    zs = torch.where(u < 0.33, z,
                     torch.where(u < 0.5, float("inf"), 0.1 + 0.8 * rand()))
    idseed = torch.where(u < 0.33, ids + step, rnd_id).to(torch.int32)
    gb = torch.rand((a,) + tuple(z.shape), generator=g, device=z.device)
    return zs, idseed, gb


_WALK_CHANS = [("rgb", 3), ("normal", 3), ("uv", 2)]
_WALK_PLANS = (dict(has_light=True, has_texture=True),    # lit + textured
               dict(has_light=False, has_texture=False))  # flat rgb


@pytest.mark.parametrize("bands", [1, 4])
@pytest.mark.parametrize("case", _WALK_CASES)
def test_bin_walk_matches_plain(case, bands):
    """K2 (static and seeded, lit + textured and flat plans) and K5
    against their plain versions: ids and depth bit for bit, planes
    within PLANE_TOL, on long bins, one crowded warp rectangle, boxes at
    rectangle and ragged frame edges, y_start, equal-depth ties (static
    and seeded lex) and no pairs at all."""
    rows, starts, bbox, a, geo, ps = _walk_inputs(case, bands)
    params = shading_params(Light.default("cuda"),
                            flat_color=(0.2, 0.5, 0.7))
    _cuda.reset_launches()
    zk, ik = tb.binned_vis_kernel(rows, starts, bbox=bbox, **geo)
    zp, ip = tb.binned_vis_plain(rows, starts, bbox=bbox, **geo)
    torch.cuda.synchronize()
    assert _equal(ik, ip) and _equal(zk, zp)
    assert bool((ik >= 0).any()) == (case != "none")
    seeds = _walk_seeds(zk, ik, ps.num_triangles, a, seed=bands)
    for plan in _WALK_PLANS:
        for sd in (None, seeds):
            kw = dict(bbox=bbox, seeds=sd, chans=_WALK_CHANS, **plan, **geo)
            zk2, ik2, ok2 = tb.fused_kernel(rows, starts, params, **kw)
            zp2, ip2, op2 = tb.fused_plain(rows, starts, params, **kw)
            torch.cuda.synchronize()
            assert _equal(ik2, ip2) and _equal(zk2, zp2)
            assert float((ok2 - op2).abs().max()) <= PLANE_TOL
            if sd is None:
                assert _equal(ik2, ik) and _equal(zk2, zk)
    assert _cuda.launches["binned_vis"] == 1
    assert _cuda.launches["fused"] == 4
    assert _cuda.launches["fused_seeded"] == 2


def _tri_records(seed, n, w, h, centre=((-1.0, 1.0), (-1.0, 1.0)),
                 size=0.2):
    """Raster records of ``n`` random triangles (corners within ``size``
    of centres drawn in the NDC box ``centre``, depth in (0.1, 0.9)),
    through the port's front-end on a w x h frame: ascending id, invalid
    rows poisoned, padded to a multiple of 128. On the card."""
    rng = np.random.default_rng(seed)
    (x0, x1), (y0, y1) = centre
    c = np.stack([rng.uniform(x0, x1, n), rng.uniform(y0, y1, n)], -1)
    xy = c[:, None, :] + rng.uniform(-size, size, (n, 3, 2))
    z = rng.uniform(0.1, 0.9, (n, 3, 1))
    corners = np.concatenate([xy, z], -1).astype(np.float32)
    ps = fe.planar_front(fe.corner_cols(torch.from_numpy(corners)),
                         torch.eye(4), w, h)
    return fe.pack_records_planar(ps, 128).cuda()


def _vis_case(case):
    """(records, width, height, y_start) of one visibility case."""
    if case == "ragged":          # 200x150: no side a multiple of 64
        return _tri_records(1, 300, 200, 150), 200, 150, 0
    if case == "y_start":         # rows [37, 137) of a 160x200 frame
        return _tri_records(2, 300, 160, 200), 160, 100, 37
    if case == "full_frame":      # one triangle beyond every frame edge
        rec = torch.cat([_full_frame_record(200, 150),
                         _tri_records(4, 40, 200, 150)])
        return rec, 200, 150, 0
    if case == "crowded":         # > 2048 records in one tile: more than
        # the block's shared list holds (2048), over two chunks of records
        rec = _tri_records(5, 5000, 256, 256, ((-0.98, -0.8), (0.8, 0.98)),
                           size=0.04)
        inside = (rec[:, 12] < 32) & (rec[:, 13] < 32) & (rec[:, 14] >= 0)
        assert int(inside.sum()) > 2048 and rec.shape[0] > 4096
        return rec, 256, 256, 0
    if case == "nan":             # every third record's depth plane NaN
        rec = _tri_records(6, 300, 200, 150)
        rec[::3, 9] = float("nan")
        return rec, 200, 150, 0
    if case == "n0":
        return torch.zeros((0, 16), device="cuda"), 200, 150, 0
    assert case == "n129"
    return _tri_records(7, 200, 200, 150)[:129].contiguous(), 200, 150, 0


def _full_frame_record(w, h):
    """One record whose triangle and bbox cover a whole w x h frame."""
    corners = torch.tensor([[[-5.0, -5.0, 0.5], [5.0, -5.0, 0.5],
                             [0.0, 5.0, 0.5]]])
    ps = fe.planar_front(fe.corner_cols(corners), torch.eye(4), w, h)
    rec = fe.pack_records_planar(ps, 128)[:1].cuda()
    assert rec[0, 10:14].tolist() == [0.0, 0.0, w - 1.0, h - 1.0]
    return rec


@pytest.mark.parametrize("case", ["ragged", "y_start", "full_frame",
                                  "crowded", "nan", "n0", "n129"])
def test_visibility_template_matches_plain(case):
    """Both modes of csrc/visibility_merge.cu against their plain versions,
    bit for bit in depth and id: clear (K3'), merge from the clear buffer
    and merge from a seeded buffer (K3)."""
    rec, w, h, y0 = _vis_case(case)
    geo = dict(width=w, height=h, y_start=y0)
    g = torch.Generator().manual_seed(8)
    seed_z = torch.where(torch.rand((h, w), generator=g) < 0.5,
                         torch.rand((h, w), generator=g), float("inf"))
    seed_id = torch.where(torch.isinf(seed_z), -1, 7).to(torch.int32)
    clear = (torch.full((h, w), float("inf"), device="cuda"),
             torch.full((h, w), -1, dtype=torch.int32, device="cuda"))
    _cuda.reset_launches()
    zc, ic = visibility_kernel(rec, **geo)
    zcp, icp = visibility_plain(rec, **geo)
    torch.cuda.synchronize()
    assert _equal(ic, icp) and _equal(zc, zcp)
    for z0, i0 in (clear, (seed_z.cuda(), seed_id.cuda())):
        zm, im = visibility_merge_kernel(rec, z0, i0, **geo)
        zmp, imp = visibility_merge_plain(rec, z0, i0, **geo)
        torch.cuda.synchronize()
        assert _equal(im, imp) and _equal(zm, zmp)
    assert _cuda.launches["visibility"] == 1
    assert _cuda.launches["visibility_merge"] == 2
    if rec.shape[0]:
        assert bool((ic >= 0).any())
    if case == "y_start":         # the band equals the full frame's rows
        zf, i_f = visibility_kernel(rec, width=w, height=200)
        torch.cuda.synchronize()
        assert _equal(ic, i_f[y0:y0 + h]) and _equal(zc, zf[y0:y0 + h])
    if case == "nan":             # a NaN depth never wins
        nan_ids = rec[::3, 14][rec[::3, 14] >= 0].int()
        assert not bool(torch.isin(ic, nan_ids).any())


def test_visibility_ties_first_drawn_or_lower_id():
    """Two records of one triangle at equal depth: the clear mode keeps
    the first drawn in the order given, the merge mode the lower id in
    either order."""
    rec = _full_frame_record(200, 150)
    pair = torch.cat([rec, rec])
    pair[:, 14] = torch.tensor([3.0, 5.0], device="cuda")
    clear = (torch.full((150, 200), float("inf"), device="cuda"),
             torch.full((150, 200), -1, dtype=torch.int32, device="cuda"))
    for order, first in ((pair, 3), (pair.flip(0).contiguous(), 5)):
        zc, ic = visibility_kernel(order, width=200, height=150)
        zm, im = visibility_merge_kernel(order, *clear, width=200,
                                         height=150)
        zmp, imp = visibility_merge_plain(order, *clear, width=200,
                                          height=150)
        torch.cuda.synchronize()
        assert bool((ic >= 0).all())
        assert bool((ic == first).all()) and bool((im == 3).all())
        assert _equal(im, imp) and _equal(zm, zmp) and _equal(zc, zm)
    zp, ip = visibility_plain(pair, width=200, height=150)
    zc, ic = visibility_kernel(pair, width=200, height=150)
    torch.cuda.synchronize()
    assert _equal(ic, ip) and _equal(zc, zp)


def _scene(name):
    """A small scene on the CPU (the card's frame is compared with it)."""
    cpu = dict(device="cpu")
    if name == "config1":          # unlit, untextured epilogue plan
        return scenes.config1_flat_cube(0.3, width=128, height=128, **cpu)
    if name == "config2":          # lit + textured
        return scenes.config2_textured_cube(0.7, width=256, height=192,
                                            **cpu)
    if name == "config2_unlit":    # unlit + textured
        return dataclasses.replace(
            scenes.config2_textured_cube(0.7, width=256, height=192, **cpu),
            light=None)
    if name == "config3":          # lit, untextured
        return scenes.config3_phong_mesh(0.5, width=256, height=256, **cpu)
    if name == "config3_generated":  # the teapot generator, no asset
        obj = scenes.TEAPOT_OBJ
        scenes.TEAPOT_OBJ = obj.with_name("no_such_teapot.obj")
        try:
            return scenes.config3_phong_mesh(0.5, width=256, height=256,
                                             **cpu)
        finally:
            scenes.TEAPOT_OBJ = obj
    return scenes.config4_many_objects(0.0, width=320, height=192,
                                       triangles=3000, **cpu)


@pytest.mark.parametrize("name", ["config1", "config2", "config2_unlit",
                                  "config3", "config3_generated",
                                  "config4"])
def test_render_on_card_matches_cpu(name):
    rp = _scene(name)
    fb_c = render(rp)
    _cuda.reset_launches()
    fb_g = render(rp.to("cuda"))
    torch.cuda.synchronize()
    assert _cuda.launches["fe"] == 1 and _cuda.launches["fused"] == 1
    cg, dg = fb_g.color.cpu(), fb_g.depth.cpu()
    assert _equal(cg[..., 3], fb_c.color[..., 3])
    assert _equal(dg, fb_c.depth)
    assert float((cg - fb_c.color).abs().max()) <= 1e-3


@pytest.mark.parametrize("backend,shading,kernel", [
    ("reference", "textured", None), ("pallas", "textured", "visibility"),
    ("auto", "flat", "binned_vis"), ("pallas", "flat", "visibility")])
def test_backends_on_card_match_cpu(backend, shading, kernel):
    rp = dataclasses.replace(_scene("config4"), shading=shading)
    fb_c = render(rp, backend=backend)
    _cuda.reset_launches()
    fb_g = render(rp.to("cuda"), backend=backend)
    torch.cuda.synchronize()
    launched = dict(_cuda.launches)
    assert launched["fe"] == 1 and launched["fused"] == 0, launched
    for k in ("visibility", "binned_vis", "resolve", "resolve_merge"):
        assert launched[k] == (k == kernel), launched
    cg, dg = fb_g.color.cpu(), fb_g.depth.cpu()
    assert bool(fb_c.color[..., 3].any())
    assert _equal(cg[..., 3], fb_c.color[..., 3])
    assert _equal(dg, fb_c.depth)
    assert float((cg - fb_c.color).abs().max()) <= 1e-3


def test_wrappers_raise_on_bad_input():
    x = torch.zeros((9, 4), device="cuda", dtype=torch.float64)
    with pytest.raises(TypeError):
        fe_kernel(x, torch.zeros(16, device="cuda"), 8, 8)
    with pytest.raises(ValueError):
        fe_kernel(torch.zeros((9, 8), device="cuda")[:, ::2],
                  torch.zeros(16, device="cuda"), 8, 8)
    cols, m16 = torch.zeros((9, 8), device="cuda"), torch.eye(4).reshape(
        16).cuda()
    for attrs, err in ((torch.zeros((6, 8), device="cuda",
                                    dtype=torch.float64), TypeError),
                       (torch.zeros((7, 8), device="cuda"), ValueError),
                       (torch.zeros((6, 9), device="cuda"), ValueError),
                       (torch.zeros((30, 8), device="cuda"), ValueError),
                       (torch.zeros((6, 8)), ValueError)):
        with pytest.raises(err):
            fe_table_kernel(cols, m16, attrs, 8, 8)
    with pytest.raises(ValueError):
        visibility_kernel(torch.zeros((8, 11), device="cuda"), width=8,
                          height=8)
    with pytest.raises(ValueError):     # rows not 16-byte aligned
        visibility_kernel(torch.zeros(8 * 16 + 1, device="cuda")[1:].view(
            8, 16), width=8, height=8)
    rows = torch.zeros((4, 17), device="cuda")
    starts = torch.zeros(2, dtype=torch.int32, device="cuda")
    tid = torch.zeros((8, 8), dtype=torch.int32, device="cuda")
    bbox = torch.zeros((4, 4), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):     # one bin, not two
        tb.binned_vis_kernel(rows, torch.zeros(3, dtype=torch.int32,
                                               device="cuda"),
                             bbox=bbox, width=8, height=8)
    with pytest.raises(TypeError):
        tb.binned_vis_kernel(rows.double(), starts, bbox=bbox, width=8,
                             height=8)
    with pytest.raises(ValueError):     # 17 columns are not 11 + 3 * 1
        tb.resolve_kernel(rows, starts, tid, n_channels=1, width=8,
                          height=8)


def test_bin_walk_raises_on_bad_bbox():
    """K2 and K5 take the bbox as [T, 4] int32, contiguous, on the rows'
    card and 16-byte aligned (int4 loads); anything else raises."""
    rows = torch.zeros((4, 17), device="cuda")
    starts = torch.zeros(2, dtype=torch.int32, device="cuda")
    words = torch.zeros(17, dtype=torch.int32, device="cuda")
    bbox = words[:16].view(4, 4)
    geo = dict(width=8, height=8)
    params = torch.zeros(32, device="cuda")
    shade = dict(chans=[("uv", 2)], has_light=False, has_texture=True,
                 bands=1)
    tb.binned_vis_kernel(rows, starts, bbox=bbox, **geo)
    tb.fused_kernel(rows, starts, params, bbox=bbox, **shade, **geo)
    for bad, err in ((bbox[:, :3].contiguous(), ValueError),  # [T, 3]
                     (bbox.reshape(16), ValueError),          # 1-d
                     (bbox.long(), TypeError),
                     (bbox.t(), ValueError),                  # strided
                     (words[1:].view(4, 4), ValueError),      # misaligned
                     (bbox.cpu(), ValueError)):
        with pytest.raises(err):
            tb.binned_vis_kernel(rows, starts, bbox=bad, **geo)
        with pytest.raises(err):
            tb.fused_kernel(rows, starts, params, bbox=bad, **shade, **geo)


def _sampler_case(th, tw, c, wrap, seed=3, cap=64, frame="mixed"):
    """Windowed-sampler inputs on the card. ``mixed``: clustered, spread
    and seam segments, garbage UVs on uncovered lanes, one empty segment;
    ``empty``: no covered lane (every nwin 0); ``seam``: every segment
    straddles the v seam."""
    g = torch.Generator().manual_seed(seed)
    data = torch.rand((th, tw, c), generator=g)
    v0 = torch.rand((cap, 1), generator=g)
    spread = torch.tensor([0.01, 0.08, 0.9])[torch.randint(
        0, 3, (cap, 1), generator=g)]
    if frame == "seam":
        v0 = 1.0 - 0.02 * torch.rand((cap, 1), generator=g)
        spread = torch.full((cap, 1), 0.04)
    v = (v0 + torch.rand((cap, 128), generator=g) * spread) % 1.0
    u = torch.rand((cap, 128), generator=g)
    cov = torch.rand((cap, 128), generator=g) < (0.0 if frame == "empty"
                                                 else 0.8)
    cov[0] = False
    u = torch.where(cov, u, 1e30)
    v = torch.where(cov, v, -3e7)
    texels = ttk.windowed_texels(data.cuda(), wrap)
    tabs = ttk.windowed_tables(data.cuda(), wrap)
    prep = ttk.windowed_prep(u.cuda(), v.cuda(), cov.cuda(), th=th, tw=tw,
                             wrap=wrap)
    return data, u, v, cov, texels, tabs, prep


@pytest.mark.parametrize("th,tw", [(128, 128), (256, 256), (64, 512)])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("wrap", ["repeat", "clamp"])
def test_sampler_kernel_matches_plain(th, tw, c, wrap):
    data, u, v, cov, texels, tabs, prep = _sampler_case(th, tw, c, wrap)
    geo = dict(th=th, tw=tw, wrap=wrap)
    _cuda.reset_launches()
    k = ttk.sample_segments_windowed(texels, *prep, c=c, **geo)
    p = ttk.sampler_plain(texels, *prep, c=c, **geo)
    torch.cuda.synchronize()
    assert _cuda.launches["sampler"] == 1
    assert _equal(k, p)
    assert _equal(k, ttk.sample_segments_windowed_plain(tabs, *prep, **geo))
    want = ttex.sample_texture_planes(
        ttex.Texture(data=data.cuda(), wrap=wrap), u.cuda(), v.cuda())
    covc = cov.cuda()
    for ch in range(c):
        assert _equal(k[ch][covc], want[ch][covc])


@pytest.mark.parametrize("frame", ["empty", "seam", "garbage"])
@pytest.mark.parametrize("c", [2, 4])
def test_sampler_kernel_edge_frames(frame, c):
    """K7 bit-equal to its plain version on a frame with no window, on
    one whose segments all straddle the v seam, and on hand-made indices
    the prep never makes (y0 outside [0, th), nwin past th / 8, dy and xa
    anywhere), where the kernel takes the remainder path."""
    th, tw, wrap = 64, 128, "repeat"
    _, _, _, cov, texels, tabs, prep = _sampler_case(
        th, tw, c, wrap, frame="mixed" if frame == "garbage" else frame)
    xa, dy, fx, fy, y0, nwin = prep
    if frame == "garbage":
        g = torch.Generator().manual_seed(5)
        cap = xa.shape[0]
        dy = torch.randint(-20, 3 * th, (cap, 128), generator=g,
                           dtype=torch.int32).cuda()
        xa = torch.randint(-9, tw + 9, (cap, 128), generator=g,
                           dtype=torch.int32).cuda()
        y0 = torch.randint(-2 * th, 2 * th, (cap,), generator=g,
                           dtype=torch.int32).cuda()
        nwin = torch.randint(0, th // 4, (cap,), generator=g,
                             dtype=torch.int32).cuda()
    geo = dict(th=th, tw=tw, wrap=wrap)
    k = ttk.sampler_kernel(texels, xa, dy, fx, fy, y0, nwin, c=c, **geo)
    p = ttk.sample_segments_windowed_plain(tabs, xa, dy, fx, fy, y0, nwin,
                                           **geo)
    torch.cuda.synchronize()
    assert _equal(k, p)
    if frame == "empty":
        assert not bool(nwin.any()) and not bool(k.any())
    else:
        assert bool(k.any())
    if frame == "seam":
        assert bool((nwin == 2).any())


def test_sampler_backward_matches_plain_autograd():
    th, tw, c, wrap = 256, 256, 3, "repeat"
    _, _, _, cov, texels, _, (xa, dy, fx, fy, y0, nwin) = _sampler_case(
        th, tw, c, wrap)
    geo = dict(c=c, th=th, tw=tw, wrap=wrap)
    cot = torch.randn((c,) + tuple(xa.shape),
                      generator=torch.Generator().manual_seed(4)).cuda()
    grads = []
    for fn in (ttk.sample_segments_windowed, ttk.sampler_plain):
        args = [t.clone().requires_grad_(True) for t in (texels, fx, fy)]
        out = fn(args[0], xa, dy, args[1], args[2], y0, nwin, **geo)
        grads.append(torch.autograd.grad(out, args, cot))
    torch.cuda.synchronize()
    for gk, gp in zip(*grads):
        assert float((gk - gp).abs().max()) <= 1e-5


@pytest.mark.parametrize("name", ["config2", "config4", "config4_adaptive"])
def test_render_windowed_on_card_matches_cpu(name, monkeypatch):
    """Route "1" (K7 once a frame) and route "adaptive" on the card
    against the CPU's frame of the same route."""
    rp = scenes.config4_many_objects(0.0, width=256, height=192,
                                     triangles=3000, device="cpu") \
        if name.startswith("config4") else _scene("config2")
    adaptive = name.endswith("adaptive")
    monkeypatch.setattr(ttex, "TEX_WINDOWED", "adaptive" if adaptive
                        else "1")
    fb_c = render(rp)
    _cuda.reset_launches()
    fb_g = render(rp.to("cuda"))
    torch.cuda.synchronize()
    if not adaptive:
        assert _cuda.launches["sampler"] == 1
    cg, dg = fb_g.color.cpu(), fb_g.depth.cpu()
    assert bool(fb_c.color[..., 3].any())
    assert _equal(cg[..., 3], fb_c.color[..., 3])
    assert _equal(dg, fb_c.depth)
    assert float((cg - fb_c.color).abs().max()) <= 1e-3


@pytest.mark.parametrize("mode", ["0", "1"])
def test_texture_train_step_on_card_matches_cpu(mode, monkeypatch):
    """One step at config 2 (128x128, 2 frames): the card's new texture
    within 1e-5 of the CPU's (the gradient's index-adds sum in another
    order; lr 5000 moves texels by up to ~0.02); in route "1" also within
    1e-5 of the card's route-"0" step. Over three more steps on the card
    the loss falls at every step."""
    monkeypatch.setattr(ttex, "TEX_WINDOWED", mode)
    rp = scenes.config2_textured_cube(0.1, width=128, height=128,
                                      device="cpu")
    ts = torch.stack([rp.transform, scenes.config2_textured_cube(
        1.1, width=128, height=128, device="cpu").transform])
    targets = render_batch(rp, ts).color
    tex0 = torch.full_like(rp.texture.data, 0.5)
    new_c, loss_c = texture_train_step(tex0, rp, ts, targets, lr=5000.0)
    card = (rp.to("cuda"), ts.cuda(), targets.cuda())
    _cuda.reset_launches()
    new_g, loss_g = texture_train_step(tex0.cuda(), *card, lr=5000.0)
    torch.cuda.synchronize()
    assert _cuda.launches["sampler"] == (2 if mode == "1" else 0)
    assert float((new_c - tex0).abs().max()) > 1e-2
    assert abs(float(loss_g) - float(loss_c)) <= 1e-5 * float(loss_c)
    assert float((new_g.cpu() - new_c).abs().max()) <= 1e-5
    if mode == "1":
        with monkeypatch.context() as m:
            m.setattr(ttex, "TEX_WINDOWED", "0")
            new_0, _ = texture_train_step(tex0.cuda(), *card, lr=5000.0)
        assert float((new_g - new_0).abs().max()) <= 1e-5
    losses, tex = [float(loss_g)], new_g
    for _ in range(3):
        tex, loss = texture_train_step(tex, *card, lr=5000.0)
        losses.append(float(loss))
    assert all(b < a for a, b in zip(losses, losses[1:])), losses


def test_geometry_grads_on_card_warn_and_zero():
    rp = _scene("config2").to("cuda")
    pos = rp.mesh.positions.clone().requires_grad_(True)
    rp = dataclasses.replace(rp, mesh=dataclasses.replace(rp.mesh,
                                                          positions=pos))
    with pytest.warns(UserWarning, match="fused pipeline stops"):
        g, = torch.autograd.grad(render(rp).color.sum(), pos)
    assert not bool(g.any())
    tex = rp.texture.data.clone().requires_grad_(True)
    rp = dataclasses.replace(rp, texture=ttex.Texture(data=tex))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        g, = torch.autograd.grad(render(rp).color.sum(), tex)
    assert bool(g.any())


def test_probe_kernels_match_plain():
    _cuda.reset_launches()
    res = probe.run(device="cuda")
    assert all(s[3] for s in res["shapes"]) and res["lookup_exact"]
    # The timing's calls are not counted: one launch per checked lookup.
    assert _cuda.launches["take_along_axis"] == len(probe.SHAPES)
    assert _cuda.launches["window_lookup"] == 1
    assert res["lookup_ms"] > 0 and res["row_gather_ms"] > 0


def test_window_lookup_clamps_outside_window_and_table():
    """Lanes outside their segment's 8-row window and indices past every
    edge of the table: the kernel reads row min(base + clamp(ty - base,
    0, 7), th - 1) with base = clamp(y0, 0, th - 1) and column clamp(tx,
    0, tw - 1); lanes inside their window and the table equal tab[ty,
    tx]."""
    rng = np.random.default_rng(11)
    th, tw, segs = 40, 300, 9
    tab = rng.random((th, tw)).astype(np.float32)
    y0 = np.array([-5, 0, 3, 30, 36, 39, 45, 100, 17], np.int32)
    ty = rng.integers(-20, 60, (segs, probe.LANES)).astype(np.int32)
    ty[-1] = y0[-1] + rng.integers(0, probe.WIN, probe.LANES)
    tx = rng.integers(-50, 350, (segs, probe.LANES)).astype(np.int32)
    base = np.clip(y0, 0, th - 1)[:, None]
    row = np.minimum(base + np.clip(ty - base, 0, probe.WIN - 1), th - 1)
    want = tab[row, np.clip(tx, 0, tw - 1)]
    got = probe.window_lookup(*(torch.from_numpy(a).cuda()
                                for a in (tab, y0, ty, tx))).cpu().numpy()
    assert np.array_equal(got, want)
    ok = ((ty >= y0[:, None]) & (ty < y0[:, None] + probe.WIN) & (ty >= 0)
          & (ty < th) & (tx >= 0) & (tx < tw))
    assert ok.sum() > probe.LANES and (~ok).sum() > probe.LANES
    assert np.array_equal(got[ok], tab[ty[ok], tx[ok]])


def test_texture_wrappers_raise_on_bad_input():
    _, _, _, _, texels, tabs, prep = _sampler_case(128, 128, 1, "repeat",
                                                   cap=4)
    geo = dict(c=1, th=128, tw=128, wrap="repeat")
    with pytest.raises(TypeError):
        ttk.sampler_kernel(texels.double(), *prep, **geo)
    with pytest.raises(ValueError):     # the table lacks its padded rows
        ttk.sampler_kernel(texels[:128].contiguous(), *prep, **geo)
    with pytest.raises(ValueError):     # planar tables, not texels
        ttk.sampler_kernel(tabs, *prep, **geo)
    with pytest.raises(ValueError):     # five channels
        ttk.sampler_kernel(texels, *prep, **dict(geo, c=5))
    with pytest.raises(ValueError):     # xa on the CPU
        ttk.sampler_kernel(texels, prep[0].cpu(), *prep[1:], **geo)
    with pytest.raises(ValueError):     # dy of the wrong shape
        ttk.sampler_kernel(texels, prep[0], prep[1][:2], *prep[2:], **geo)
    fx = torch.zeros(4 * 128 + 1, device="cuda")[1:].view(4, 128)
    with pytest.raises(ValueError):     # fx not 16-byte aligned
        ttk.sampler_kernel(texels, *prep[:2], fx, *prep[3:], **geo)
    x = torch.zeros((8, 128), device="cuda")
    idx = torch.zeros((8, 128), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError):
        probe.take_along_axis(x, idx, 2)
    with pytest.raises(TypeError):
        probe.take_along_axis(x, idx.long(), 0)
    with pytest.raises(ValueError):
        probe.window_lookup(x, torch.zeros(2, dtype=torch.int32,
                                           device="cuda"), idx, idx)


# ---------------------------------------------------------------------------
# The camera path: K1's perspective flag, K2's perspective plan, the clip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [5000, 77])
@pytest.mark.parametrize("n_chan", [0, 2, 8])
def test_fe_table_kernel_perspective_matches_plain(n_chan, t):
    """K1 with the perspective flag: rows and the table of the values
    over w and the 1/w channel bit-equal to the plain composition, on the
    poison cases (degenerate, offscreen, behind the near plane, NaN
    corner) and a NaN attribute."""
    cols, m16, attrs = _fe_table_case(t, n_chan, seed=11)
    _cuda.reset_launches()
    rows, table = fe_table_kernel(cols, m16, attrs, 1920, 1080,
                                  cull_backfaces=True, perspective=True)
    assert _cuda.launches["fe"] == 1 and _cuda.launches["fe_persp"] == 1
    p_rows, p_table = fe_table_plain(cols, m16, attrs, 1920, 1080,
                                     cull_backfaces=True, perspective=True)
    torch.cuda.synchronize()
    assert table.shape == (t, 11 + 3 * (n_chan + 1))
    assert _equal(rows, p_rows) and _equal(table, p_table)
    valid = rows[fe.FE_ROWS.index("valid")] != 0
    assert not bool(valid[:4].any()) and 0 < int(valid.sum()) < t
    poison = fe._stream_poison(11 + 3 * (n_chan + 1), "cuda")
    assert _equal(table[~valid], poison.expand(int((~valid).sum()), -1))
    invw = table[valid, -3:]          # the 1/w planes: finite
    assert bool(torch.isfinite(invw).all())


def _persp_walk_inputs(case, bands):
    """A bin-walk case (see _walk_case) with the perspective plan's
    channels: the 8 values over random corner w in [0.2, 3], then 1/w."""
    ps, attrs, h, y0 = _walk_case(case)
    g = torch.Generator().manual_seed(bands)
    w = (0.2 + 2.8 * torch.rand((ps.num_triangles, 3), generator=g)).cuda()
    vals = torch.stack([torch.stack(c, dim=1) for c in attrs], dim=2)
    pv = fe.attr_corner_cols(tsh.perspective_vertex_attrs(vals, w))
    info = tb.build_bins(ps, width=_WALK_W, height=h, y_start=y0,
                         kmax=10_000, pair_budget_factor=1e4, bands=bands)
    table, a, poison = fe.stream_table_planar(
        ps, fe.attribute_plane_cols(ps, pv))
    assert a == 9
    rows = tb.gather_stream(table, info.ids, poison).contiguous()
    geo = dict(width=_WALK_W, height=h, y_start=y0, bands=bands)
    return rows, info.bin_start, fe.bbox_table(ps), geo, ps


@pytest.mark.parametrize("bands", [1, 4])
@pytest.mark.parametrize("case", ["long", "edges", "y_start", "ties"])
def test_bin_walk_perspective_matches_plain(case, bands):
    """K2's perspective plan, static and seeded (the seed G-buffer's last
    plane 1/w > 0), lit + textured and flat plans, against the plain
    perspective_epilogue: ids and depth bit for bit, planes within
    PLANE_TOL."""
    rows, starts, bbox, geo, ps = _persp_walk_inputs(case, bands)
    params = shading_params(Light.default("cuda"),
                            flat_color=(0.2, 0.5, 0.7))
    zk, ik = tb.binned_vis_kernel(rows, starts, bbox=bbox, **geo)
    zs, ids, gb = _walk_seeds(zk, ik, ps.num_triangles, 9, seed=bands)
    gb[8] = 0.2 + gb[8]               # a seed's 1/w is > 0
    _cuda.reset_launches()
    for plan in _WALK_PLANS:
        for sd in (None, (zs, ids, gb)):
            kw = dict(bbox=bbox, seeds=sd, chans=_WALK_CHANS,
                      perspective=True, **plan, **geo)
            zk2, ik2, ok2 = tb.fused_kernel(rows, starts, params, **kw)
            zp2, ip2, op2 = tb.fused_plain(rows, starts, params, **kw)
            torch.cuda.synchronize()
            assert _equal(ik2, ip2) and _equal(zk2, zp2)
            assert bool(torch.isfinite(ok2).all())
            assert float((ok2 - op2).abs().max()) <= PLANE_TOL
    assert _cuda.launches["fused_persp"] == 4
    assert _cuda.launches["fused_persp_seeded"] == 2


def test_overflow_kernels_at_nine_channels_match_plain():
    """The spill path of a perspective frame: K3, K4 at 9 channels (the 8
    over w and 1/w) and the seeded perspective K2 on config 4's cut
    camera scene, against their plain versions."""
    rp = scenes.config4_camera(0.0, width=320, height=180, triangles=3000,
                               device="cuda")
    setup, pv, chans, prm, _, _ = clip_inputs(rp)
    ps = fe.from_setup(setup)
    table, a, poison = fe.stream_table_planar(
        ps, fe.attribute_plane_cols(ps, fe.attr_corner_cols(pv)))
    w, h = rp.width, rp.height
    info = tb.build_bins(ps, width=w, height=h, kmax=1, bands=4)
    assert a == 9 and info.n_overflow > 0
    ov = torch.nonzero(info.overflow_mask).squeeze(1).to(torch.int32)
    rec = tb.gather_stream(fe.pack_records_planar(ps, 128), ov,
                           _poison_row("cuda")).contiguous()
    z0 = torch.full((h, w), float("inf"), device="cuda")
    i0 = torch.full((h, w), -1, dtype=torch.int32, device="cuda")
    z3, i3 = visibility_merge_kernel(rec, z0, i0, width=w, height=h)
    ov_rows = tb.gather_stream(table, ov, poison).contiguous()
    g0 = torch.zeros((a, h, w), device="cuda")
    gk = tb.resolve_merge_kernel(ov_rows, i3, g0, width=w, height=h)
    gp = tb.resolve_merge_plain(ov_rows, i3, g0, width=w, height=h)
    rows = tb.gather_stream(table, info.ids, poison).contiguous()
    kw = dict(width=w, height=h, chans=chans, has_light=True,
              has_texture=True, bands=4, bbox=fe.bbox_table(ps),
              seeds=(z3, i3, gk), perspective=True)
    zk, ik, ok = tb.fused_kernel(rows, info.bin_start, prm, **kw)
    zp, ip, op = tb.fused_plain(rows, info.bin_start, prm, **kw)
    torch.cuda.synchronize()
    assert bool((i3 >= 0).any())
    assert float((gk - gp).abs().max()) <= PLANE_TOL
    assert _equal(ik, ip) and _equal(zk, zp)
    assert bool(torch.isfinite(ok).all())
    assert float((ok - op).abs().max()) <= PLANE_TOL


def _camera_scene(name):
    """The camera scenes of tests/test_torch_camera.py, built by the port
    on the CPU."""
    cpu = dict(device="cpu")
    if name.startswith("config4"):
        return scenes.config4_camera(0.0, width=160, height=90,
                                     triangles=3000, **cpu)
    quad = np.array([0, 1, 2, 0, 2, 3])
    if name == "straddle":
        pos = np.array([[-1.0, -0.3, 1.0], [1.0, -0.3, 1.0],
                        [1.0, -0.3, -4.0], [-1.0, -0.3, -4.0]], np.float32)
        mesh = mesh_from_numpy(pos, quad, colors=np.array(
            [[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0]], np.float32), **cpu)
        view = tf.look_at((0.0, 0.4, 0.0), (0.0, -0.3, -2.0), **cpu)
        return RenderPass(
            mesh=mesh, transform=tf.perspective(
                np.pi / 3, 1.0, 0.1, 10.0, **cpu) @ view,
            width=96, height=96, clip_near=True)
    lit = name == "slanted_lit"
    pos = np.array([[-0.5, -0.2, -0.5], [0.5, -0.2, -0.5],
                    [0.5, -0.2, -3.0], [-0.5, -0.2, -3.0]], np.float32)
    mesh = mesh_from_numpy(
        pos, quad, colors=np.ones((4, 3), np.float32),
        uvs=np.array([[0, 1], [1, 1], [1, 0], [0, 0]], np.float32),
        normals=np.tile(np.float32([0, 1, 0]), (4, 1)) if lit else None,
        **cpu)
    view = tf.look_at((0.0, 0.3, 0.5), (0.0, -0.2, -2.0), **cpu)
    return RenderPass(
        mesh=mesh, transform=tf.perspective(np.pi / 3, 1.0, 0.1, 10.0,
                                            **cpu) @ view,
        width=64, height=64, shading="textured",
        texture=ttex.checkerboard(64, 8, device="cpu"),
        perspective_correct=True,
        light=Light.default("cpu") if lit else None,
        model=torch.eye(4) if lit else None)


@pytest.mark.parametrize("name,backend,kernels", [
    ("straddle", "auto", ("fused",)),
    ("slanted", "auto", ("fe_persp", "fused_persp")),
    ("slanted_lit", "auto", ("fe_persp", "fused_persp")),
    ("config4_camera", "auto", ("fused_persp",)),
    ("config4_camera", "pallas", ("visibility",)),
    ("config4_camera", "reference", ()),
    ("config4_camera_flat", "auto", ("binned_vis",))])
def test_camera_render_on_card_matches_cpu(name, backend, kernels):
    """The camera scenes on the card against the CPU's plain versions:
    alpha and depth bit for bit, color within 1e-3; the clip front-end
    runs as torch ops on both, so the setups are the same."""
    rp = _camera_scene(name)
    if name.endswith("flat"):
        rp = dataclasses.replace(rp, shading="flat")
    fb_c = render(rp, backend=backend)
    _cuda.reset_launches()
    fb_g = render(rp.to("cuda"), backend=backend)
    torch.cuda.synchronize()
    for k in kernels:
        assert _cuda.launches[k] >= 1, (k, dict(_cuda.launches))
    if rp.clip_near:
        assert _cuda.launches["fe"] == 0, dict(_cuda.launches)
    cg, dg = fb_g.color.cpu(), fb_g.depth.cpu()
    assert bool(fb_c.color[..., 3].any())
    assert bool(torch.isfinite(cg).all())
    assert _equal(cg[..., 3], fb_c.color[..., 3])
    assert _equal(dg, fb_c.depth)
    assert float((cg - fb_c.color).abs().max()) <= 1e-3


def test_clipped_flat_frame_binned_equals_record_walk():
    """Over the clip's [2T] setup (config 4's cut camera scene): K5 (flat
    shading, the binned pass with K3 on its spills) and K2's perspective
    plan (the textured camera frame, seeded from K3 and K4) equal the
    record walk K3' on every record, bit for bit in depth and id."""
    rp = scenes.config4_camera(0.0, width=320, height=180, triangles=3000,
                               device="cuda")
    setup, _, _ = clip_front(
        rp.mesh.positions[rp.mesh.triangles().long()], rp.transform,
        rp.width, rp.height, cull_backfaces=True)
    _, pv, chans, prm, lit, tex = clip_inputs(rp)
    _cuda.reset_launches()
    d5, i5 = tb.visibility_binned(setup, width=320, height=180)
    d3, i3 = visibility_kernel(fe.pack_records_planar(fe.from_setup(setup),
                                                      128),
                               width=320, height=180)
    d2, i2, _ = tb.fused_pipeline(setup, pv, prm, width=320, height=180,
                                  chans=chans, has_light=lit,
                                  has_texture=tex, perspective=True)
    torch.cuda.synchronize()
    assert _cuda.launches["binned_vis"] == 1
    assert _cuda.launches["fused_persp"] == 1
    assert bool((i5 >= 0).any())
    assert _equal(i5, i3) and _equal(d5, d3)
    assert _equal(i2, i3) and _equal(d2, d3)


def test_clip_is_a_no_op_in_front_on_card():
    """Config 4's own frame has every corner in front of the near plane,
    so on the card it renders bit for bit the same with and without
    clip_near, with perspective-correct attributes off and on."""
    rp = scenes.config4_many_objects(0.0, width=320, height=192,
                                     triangles=3000, device="cuda")
    for persp in (False, True):
        base = dataclasses.replace(rp, perspective_correct=persp)
        plain = render(base)
        clipped = render(dataclasses.replace(base, clip_near=True))
        torch.cuda.synchronize()
        assert bool(plain.color[..., 3].any())
        assert _equal(clipped.color, plain.color), persp
        assert _equal(clipped.depth, plain.depth), persp


def test_perspective_wrappers_raise_on_bad_input():
    """K2's perspective plan takes at most 9 channels with the 1/w
    channel last; K1's flag needs the table and leaves room for 1/w."""
    starts = torch.zeros(2, dtype=torch.int32, device="cuda")
    bbox = torch.zeros((4, 4), dtype=torch.int32, device="cuda")
    params = torch.zeros(32, device="cuda")
    geo = dict(width=8, height=8, bands=1, bbox=bbox)
    plan = dict(chans=_WALK_CHANS, has_light=True, has_texture=True)
    with pytest.raises(ValueError, match="1/w"):   # 11 + 3 * 8: no 1/w
        tb.fused_kernel(torch.zeros((4, 35), device="cuda"), starts, params,
                        perspective=True, **plan, **geo)
    wide = [("rgb", 3), ("normal", 3), ("uv", 2), ("extra", 1)]
    with pytest.raises(ValueError, match="at most 9"):
        tb.fused_kernel(torch.zeros((4, 41), device="cuda"), starts, params,
                        perspective=True, chans=wide, has_light=True,
                        has_texture=True, **geo)
    tb.fused_kernel(torch.zeros((4, 38), device="cuda"), starts, params,
                    perspective=True, **plan, **geo)
    cols, m16 = torch.zeros((9, 8), device="cuda"), torch.eye(4).reshape(
        16).cuda()
    with pytest.raises(ValueError):                # 9 channels and 1/w
        fe_table_kernel(cols, m16, torch.zeros((27, 8), device="cuda"), 8,
                        8, perspective=True)


def test_render_pass_built_on_card_with_default_flat_color():
    """A RenderPass whose mesh and transform are on the card but whose
    flat_color is the dataclass default (a CPU tensor) renders on the
    card (the shading row follows the mesh), equal to the CPU frame."""
    rp = scenes.config1_flat_cube(0.3, width=128, height=128, device="cpu")
    rp = RenderPass(mesh=rp.mesh, transform=rp.transform, width=128,
                    height=128, shading="vertex")
    fb_c = render(rp)
    on_card = RenderPass(mesh=rp.mesh.to("cuda"),
                         transform=rp.transform.to("cuda"), width=128,
                         height=128, shading="vertex")
    assert on_card.flat_color.device.type == "cpu"
    fb_g = render(on_card)
    torch.cuda.synchronize()
    cg = fb_g.color.cpu()
    assert bool(fb_c.color[..., 3].any())
    assert _equal(cg[..., 3], fb_c.color[..., 3])
    assert _equal(fb_g.depth.cpu(), fb_c.depth)
    assert float((cg - fb_c.color).abs().max()) <= 1e-3


# ---------------------------------------------------------------------------
# The rest of the public surface: trilinear, row bands, supersampling,
# lines and points, pixel formats, resize, 2D primitives, constructors.
# ---------------------------------------------------------------------------

def _trilinear(rp):
    return dataclasses.replace(rp, texture=ttex.Texture(
        data=rp.texture.data, filter="trilinear", wrap=rp.texture.wrap))


def _launched(kernels, what):
    """Each kernel launched once (``fused`` counts K2's static and seeded
    launches)."""
    for k in kernels:
        assert _cuda.launches[k] == 1, (what, k, dict(_cuda.launches))


def _card_equals_cpu(fb_c, fb_g, what):
    cg, dg = fb_g.color.cpu(), fb_g.depth.cpu()
    assert bool(fb_c.color[..., 3].any()), what
    assert bool(torch.isfinite(cg).all()), what
    assert _equal(cg[..., 3], fb_c.color[..., 3]), what
    assert _equal(dg, fb_c.depth), what
    assert float((cg - fb_c.color).abs().max()) <= 1e-3, what


@pytest.mark.parametrize("name,backend,kernels", [
    ("config2", "auto", ("fe", "fused")),
    ("config4", "auto", ("fe", "fused")),
    ("config2", "pallas", ("fe", "visibility"))])
def test_trilinear_render_on_card_matches_cpu(name, backend, kernels):
    rp = _trilinear(_scene(name))
    fb_c = render(rp, backend=backend)
    _cuda.reset_launches()
    fb_g = render(rp.to("cuda"), backend=backend)
    torch.cuda.synchronize()
    _launched(kernels, f"trilinear {name} {backend}")
    _card_equals_cpu(fb_c, fb_g, f"trilinear {name} {backend}")


@pytest.mark.parametrize("backend,shading,kernels", [
    ("auto", "textured", ("fe", "fused")),
    ("binned", "textured", ("fe", "fused")),
    ("auto", "flat", ("fe", "binned_vis")),
    ("pallas", "textured", ("fe", "visibility")),
    ("reference", "textured", ())])
def test_render_rows_on_card_matches_cpu(backend, shading, kernels):
    """Rows [37, 137) of config 4 (3,000 triangles, 320x192) on the card
    against the CPU's band and the card's own full frame."""
    from software_renderer_tpu_torch import render_rows
    rp = dataclasses.replace(_scene("config4"), shading=shading)
    fb_c = render_rows(rp, 37, 100, backend=backend)
    full = render(rp.to("cuda"), backend=backend)
    _cuda.reset_launches()
    fb_g = render_rows(rp.to("cuda"), 37, 100, backend=backend)
    torch.cuda.synchronize()
    _launched(kernels, f"rows {backend} {shading}")
    _card_equals_cpu(fb_c, fb_g, f"rows {backend} {shading}")
    assert _equal(fb_g.color[..., 3], full.color[37:137, :, 3])
    assert _equal(fb_g.depth, full.depth[37:137])


def test_render_msaa_on_card_matches_cpu():
    from software_renderer_tpu_torch import render_msaa
    rp = scenes.config4_many_objects(0.0, width=160, height=96,
                                     triangles=3000, device="cpu")
    fb_c = render_msaa(rp, 2)
    _cuda.reset_launches()
    fb_g = render_msaa(rp.to("cuda"), 2)
    torch.cuda.synchronize()
    _launched(("fe", "fused"), "msaa")
    assert fb_g.color.shape == (96, 160, 4)
    _card_equals_cpu(fb_c, fb_g, "msaa")


def test_lines_and_points_on_card_match_cpu():
    """The last writer wins on the card as on the CPU: duplicate pixels,
    lines crossing, and the line and point primitives, bit for bit."""
    from software_renderer_tpu_torch.ops import lines as tl
    g = torch.Generator().manual_seed(12)
    img = torch.rand((64, 96, 4), generator=g)
    k = 5000
    xs = torch.randint(-3, 99, (k,), generator=g, dtype=torch.int32)
    ys = torch.randint(-3, 67, (k,), generator=g, dtype=torch.int32)
    cols = torch.rand((k, 4), generator=g)
    mask = torch.rand(k, generator=g) < 0.9
    want = tl.scatter_points(img, xs, ys, cols, mask)
    got = tl.scatter_points(*(t.cuda() for t in (img, xs, ys, cols, mask)))
    assert _equal(got.cpu(), want)
    screen = torch.round(torch.rand((300, 3), generator=g)
                         * torch.tensor([120.0, 90.0, 1.0]) - 10.0)
    lines = torch.randint(0, 300, (2000, 2), generator=g, dtype=torch.int32)
    want = tl.draw_lines(img, screen, lines, cols[:300])
    got = tl.draw_lines(img.cuda(), screen.cuda(), lines.cuda(),
                        cols[:300].cuda())
    assert _equal(got.cpu(), want)
    for rp in (scenes.wireframe_cube(0.7, width=96, height=64, device="cpu"),
               dataclasses.replace(scenes.reference_sphere(
                   0.3, width=96, height=64, device="cpu"),
                   primitive="vertices")):
        fb_c = render(rp)
        fb_g = render(rp.to("cuda"))
        assert bool((fb_c.color[..., 3] > 0).any())
        assert _equal(fb_g.color.cpu(), fb_c.color)
        assert _equal(fb_g.depth.cpu(), fb_c.depth)


def test_formats_resize_primitives_on_card_match_cpu():
    from software_renderer_tpu_torch import (PIXEL_FORMATS, decode_pixels,
                                             encode_pixels)
    from software_renderer_tpu_torch.ops import primitives2d as p2
    from software_renderer_tpu_torch.ops.resize import (resize_bilinear,
                                                        resize_nearest)
    g = torch.Generator().manual_seed(13)
    c = torch.rand((48, 80, 4), generator=g) * 1.2 - 0.1
    for fmt in PIXEL_FORMATS:
        ec, eg = encode_pixels(c, fmt), encode_pixels(c.cuda(), fmt)
        assert eg.dtype == ec.dtype, fmt
        d = (eg.cpu().to(torch.float64) - ec.to(torch.float64)).abs().max()
        assert float(d) <= (1 if fmt == "gray8" else 0), fmt
        assert _equal(decode_pixels(ec.cuda(), fmt).cpu(),
                      decode_pixels(ec, fmt)), fmt
    for out in ((31, 47), (120, 200)):
        b = resize_bilinear(c.cuda(), *out).cpu()
        assert float((b - resize_bilinear(c, *out)).abs().max()) <= 1e-5
        assert _equal(resize_nearest(c.cuda(), *out).cpu(),
                      resize_nearest(c, *out))
    draws = [lambda im: p2.draw_rect(im, 7.3, 11.0, 40.5, 20.25, (1, 0, 0)),
             lambda im: p2.draw_circle(im, 40.0, 30.5, 17.0, (0, 0, 1)),
             lambda im: p2.draw_line(im, 2.0, 40.0, 71.0, 3.0, (0, 1, 0)),
             lambda im: p2.draw_triangle2d(im, (30, 2.5), (3, 41), (73, 40))]
    for draw in draws:
        assert _equal(draw(c.cuda()).cpu(), draw(c))


def test_new_constructors_default_to_the_card():
    import software_renderer_tpu_torch as srt
    made = [srt.create_framebuffer(8, 4).color, srt.shapes.plane().positions,
            scenes.rotating_triangle(0.3).mesh.positions,
            scenes.wireframe_cube(0.3).transform,
            scenes.intersecting_triangles(0.3).mesh.colors,
            srt.RenderConfig().projection_matrix(),
            srt.RenderConfig(projection="perspective").projection_matrix()]
    assert all(t.device.type == "cuda" for t in made)


def _config4_loop_scene(t):
    """Config 4 cut to 3,000 triangles at 256x192 on the card, bench.py's
    rotation at t seconds."""
    rp = scenes.config4_many_objects(0.0, width=256, height=192,
                                     triangles=3000)
    axis = tf.normalize(torch.tensor([1.0, 1.0, 0.0], device="cuda"))
    q = tf.quat_from_axis_angle(axis, torch.tensor(t, device="cuda"))
    return dataclasses.replace(rp, transform=rp.transform
                               @ tf.rotation_matrix(q))


def test_frame_loop_and_viewer_on_card(tmp_path):
    """FrameLoop on the card with the PNG sink (native runtime), the
    viewer and no sink: K1 and K2 launch every frame; the PNG files and
    the viewer's frame decode to to_rgba8 of the card frame."""
    import urllib.request
    from software_renderer_tpu_torch import runtime, to_rgba8
    from software_renderer_tpu_torch.utils.config import RenderConfig
    from software_renderer_tpu_torch.utils.display import FrameLoop
    from software_renderer_tpu_torch.utils.image_io import decode_png
    from software_renderer_tpu_torch.utils.present import PresentServer
    cfg = RenderConfig(width=256, height=192, time_step=0.5)
    want = [to_rgba8(render(_config4_loop_scene(0.5 * i)).color).cpu()
            for i in range(3)]
    for sink in ("png", "viewer", None):
        loop = FrameLoop(_config4_loop_scene, config=cfg)
        _cuda.reset_launches()
        if sink == "viewer":
            with PresentServer() as srv:
                loop.run(3, present=srv)
                with urllib.request.urlopen(srv.url + "frame.png",
                                            timeout=10) as r:
                    png = r.read()
            assert _equal(torch.from_numpy(decode_png(png)), want[2])
        else:
            loop.run(3, out_dir=str(tmp_path) if sink else None)
        torch.cuda.synchronize()
        assert _cuda.launches["fe"] == 3 and _cuda.launches["fused"] == 3
    assert runtime.available()
    for i in range(3):
        got = runtime.read_png(str(tmp_path / f"frame_{i:05d}.png"))
        assert _equal(torch.from_numpy(got), want[i])


def test_batches_and_sharded_bands_on_card():
    """render_batch_chunked equals render_batch bit for bit; render_sharded
    on a 2 x 2 mesh of the one card (split front-end on and off) and on
    make_mesh(1, 1) equals it too, and the gathered front-end and stream
    table equal the unsplit K1 launch's (K1 is per-triangle)."""
    from software_renderer_tpu_torch.parallel.batch import (
        render_batch_chunked)
    from software_renderer_tpu_torch.parallel.sharding import (
        make_mesh, render_sharded, sharded_front)
    from software_renderer_tpu_torch.render import planar_front_table_of
    rp = _config4_loop_scene(0.0)
    ts = torch.stack([_config4_loop_scene(0.5 * i).transform
                      for i in range(4)])
    ref = render_batch(rp, ts)
    fb = render_batch_chunked(rp, ts, vmap_chunk=2)
    assert _equal(fb.color, ref.color) and _equal(fb.depth, ref.depth)
    cuda0 = torch.device("cuda", 0)
    for mesh, split in ((make_mesh(2, 2, [cuda0] * 4), True),
                        (make_mesh(2, 2, [cuda0] * 4), False),
                        (make_mesh(1, 1), True)):
        _cuda.reset_launches()
        fb = render_sharded(rp, ts, mesh, shard_frontend=split)
        torch.cuda.synchronize()
        assert _cuda.launches["fe"] > 0 and _cuda.launches["fused"] > 0
        assert _equal(fb.color, ref.color) and _equal(fb.depth, ref.depth)
    front, (table, _, _) = sharded_front(rp.to, ts[1], [cuda0] * 4)[cuda0]
    unsplit, (u_table, _, _) = planar_front_table_of(
        dataclasses.replace(rp, transform=ts[1]))
    t = unsplit.num_triangles
    for f in dataclasses.fields(fe.PlanarSetup):
        assert _equal(getattr(front, f.name)[:t], getattr(unsplit, f.name))
    assert _equal(table[:t], u_table)


def test_texture_train_step_over_a_mesh_on_card(monkeypatch):
    """One step in mode "1" on a 2 x 2 mesh of the one card against the
    meshless step: loss within rel 1e-5, texels within 1e-5 (the bands'
    gradients sum in another order)."""
    from software_renderer_tpu_torch.parallel.sharding import make_mesh
    monkeypatch.setattr(ttex, "TEX_WINDOWED", "1")
    rp = _config4_loop_scene(0.0)
    ts = torch.stack([_config4_loop_scene(0.5 * i).transform
                      for i in range(4)])
    targets = render_batch(rp, ts).color
    tex0 = torch.full_like(rp.texture.data, 0.5)
    new, loss = texture_train_step(tex0, rp, ts, targets, lr=5000.0)
    new_m, loss_m = texture_train_step(
        tex0, rp, ts, targets, make_mesh(2, 2, ["cuda:0"] * 4), lr=5000.0)
    torch.cuda.synchronize()
    assert float((new - tex0).abs().max()) > 1e-3
    assert abs(float(loss_m) - float(loss)) <= 1e-5 * float(loss)
    assert float((new_m - new).abs().max()) <= 1e-5


# ---------------------------------------------------------------------------
# The compiled frame: no host sync in a frame, the kernels' device counts,
# and render_batch / FrameLoop replaying one captured frame.
# ---------------------------------------------------------------------------

def _render_bins(rp):
    """The bins render() builds for a triangle RenderPass on the main
    path (bands, kmax and pair budget as ops/binning.py and render.py
    choose them)."""
    ps = triangle_inputs(rp)[0]
    bands = (tb.FUSED_BANDS if ps.num_triangles >= tb.FUSED_BANDS_MIN_T
             else 1)
    return tb.build_bins(ps, width=rp.width, height=rp.height,
                         kmax=tb.KMAX * bands, bands=bands,
                         pair_budget_factor=0.85 if rp.cull_backfaces
                         else 3.0)


def _sync_free(fn):
    """``fn()`` after a warm-up, under sync debug mode "error" (a host
    sync raises)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _sync_count(fn):
    """(``fn()``, the host syncs sync debug mode "warn" reports in it)."""
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message) for w in got)


def _sync_route(name):
    """(CPU RenderPass, route) of a host-sync case: the route renders the
    pass on its own device as one public entry does."""
    from software_renderer_tpu_torch.render import render_rows
    from software_renderer_tpu_torch.parallel.sharding import (
        make_mesh, render_sharded)
    if name == "config2_kmax1":
        return scenes.config2_textured_cube(0.7, width=256, height=192,
                                            device="cpu"), render
    if name == "camera":
        return scenes.config4_camera(0.0, width=256, height=144,
                                     triangles=3000, device="cpu"), render
    rp = scenes.config4_many_objects(0.0, width=384, height=192,
                                     triangles=3000, device="cpu")
    if name == "flat":
        return dataclasses.replace(rp, shading="flat"), render
    if name == "rows":
        return rp, lambda p: render_rows(p, 37, 100)
    if name == "binned_pipeline":       # with attributes, from K1's table
        def pipeline(p):
            ps, table = planar_front_table_of(p)
            return tb.binned_pipeline(ps, None, width=p.width,
                                      height=p.height, stream_table=table,
                                      pair_budget_factor=0.85)
        return rp, pipeline
    if name == "sharded":               # a 1 x 2 mesh, the split front-end
        turn = tf.rotation_matrix(tf.quat_from_axis_angle(
            tf.normalize(torch.tensor([1.0, 1.0, 0.0])), torch.tensor(0.5)))
        made = {}                       # built once per device: a copy to
        # the card inside the route would be a host sync of its own

        def sharded(p):
            dev = p.transform.device
            if dev not in made:
                made[dev] = (torch.stack([p.transform,
                                          p.transform @ turn.to(dev)]),
                             make_mesh(1, 2, [dev, dev]))
            return render_sharded(p, *made[dev])
        return rp, sharded
    return rp, render


@pytest.mark.parametrize("name,mode", [
    ("config4", "0"), ("config4", "1"), ("config2_kmax1", "0"),
    ("config2_kmax1", "1"), ("config4", "adaptive"), ("camera", "0"),
    ("camera", "1"), ("flat", "0"), ("binned_pipeline", "0"), ("rows", "0"),
    ("sharded", "0")])
def test_render_makes_no_host_sync(name, mode, monkeypatch):
    """render() of a spill-free frame (config 4 cut down) and of a frame
    whose multi-bin triangles all spill (config 2 with kmax 1), with
    either sampler route, syncs nothing with the host, and "adaptive"
    only its one predicate read; nor do the camera path (clip +
    perspective) in either route, flat shading, binned_pipeline with
    attributes, a render_rows band and render_sharded. The frames equal
    the CPU's."""
    monkeypatch.setattr(ttex, "TEX_WINDOWED", mode)
    if name == "config2_kmax1":
        monkeypatch.setattr(tb, "KMAX", 1)
    rp, route = _sync_route(name)
    card = rp.to("cuda")
    if name in ("config4", "config2_kmax1"):
        n_ov = int(_render_bins(card).n_overflow)
        assert (n_ov > 0) == (name == "config2_kmax1"), n_ov
    _cuda.reset_launches()
    if mode == "adaptive":
        route(card)
        torch.cuda.synchronize()
        got, n_sync = _sync_count(lambda: route(card))
        assert n_sync <= 1, n_sync
    else:
        got = _sync_free(lambda: route(card))
    torch.cuda.synchronize()
    if mode == "1":
        assert _cuda.launches["sampler"] > 0, dict(_cuda.launches)
    want = route(rp)
    if name == "binned_pipeline":       # (depth, ids, G-buffer)
        assert _equal(got[0].cpu(), want[0]) and bool((want[1] >= 0).any())
        assert _equal(got[1].cpu(), want[1])
        assert float((got[2].cpu() - want[2]).abs().max()) <= PLANE_TOL
    else:
        _card_equals_cpu(want, got, f"{name} mode {mode}")


@pytest.mark.parametrize("bands", [1, 4])
def test_count_kernels_match_plain(bands):
    """K2, K3 and K4 with the device count, against their plain versions
    with the same count: at 0 (K2 the static walk bit for bit, reading no
    seed; K3 and K4 their seeds unchanged) and above 0 (the kmax=1 spill
    over the static overflow list, equal to the compact list's run)."""
    rp = scenes.config4_many_objects(0.0, width=320, height=192,
                                     triangles=3000, device="cuda")
    ps, chans, attrs, prm, _, _ = triangle_inputs(rp)
    w, h = rp.width, rp.height
    table, a, poison = fe.stream_table_planar(
        ps, fe.attribute_plane_cols(ps, attrs))
    bbox = fe.bbox_table(ps)
    kw = dict(width=w, height=h, chans=chans, has_light=True,
              has_texture=True, bands=bands, bbox=bbox)
    junk = (torch.full((h, w), -5.0, device="cuda"),
            torch.full((h, w), 7, dtype=torch.int32, device="cuda"),
            torch.full((a, h, w), 3.0, device="cuda"))
    zero = torch.zeros((), dtype=torch.int32, device="cuda")
    info0 = tb.build_bins(ps, width=w, height=h, kmax=12 * bands,
                          bands=bands)
    assert int(info0.n_overflow) == 0
    rows0 = tb.gather_stream(table, info0.ids, poison).contiguous()
    static = tb.fused_kernel(rows0, info0.bin_start, prm, **kw)
    for fn in (tb.fused_kernel, tb.fused_plain):
        got = fn(rows0, info0.bin_start, prm, seeds=junk,
                 n_overflow=info0.n_overflow, **kw)
        torch.cuda.synchronize()
        assert all(_equal(g, s) for g, s in zip(got, static)), fn.__name__

    info = tb.build_bins(ps, width=w, height=h, kmax=1, bands=bands)
    n = info.n_overflow
    assert int(n) > 0
    ov, slots = tb.overflow_ids(info.overflow_mask)
    ov_rows = tb.gather_stream(table, ov, poison).contiguous()
    rec = tb.raster_records(ov_rows, bbox, ov)
    z0 = torch.full((h, w), float("inf"), device="cuda")
    i0 = torch.full((h, w), -1, dtype=torch.int32, device="cuda")
    zk, ik = visibility_merge_kernel(rec, z0, i0, width=w, height=h,
                                     n_live=n)
    zp, ip = visibility_merge_plain(rec, z0, i0, width=w, height=h,
                                    n_live=n)
    rec_c = rec[:int(n)].contiguous()
    zc, ic = visibility_merge_kernel(rec_c, z0, i0, width=w, height=h)
    z_0, i_0 = visibility_merge_kernel(rec, junk[0], junk[1], width=w,
                                       height=h, n_live=zero)
    torch.cuda.synchronize()
    assert _equal(ik, ip) and _equal(zk, zp) and bool((ik >= 0).any())
    assert _equal(ik, ic) and _equal(zk, zc)
    assert _equal(z_0, junk[0]) and _equal(i_0, junk[1])
    # With no seed K4 defines the overflow winners' pixels only (all that
    # K2 reads of its seed planes).
    gk = tb.resolve_merge_kernel(ov_rows, ik, None, width=w, height=h,
                                 n_live=n, slots=slots)
    gp = tb.resolve_merge_plain(ov_rows, ik, None, width=w, height=h,
                                n_live=n, slots=slots)
    g_0 = tb.resolve_merge_kernel(ov_rows, ik, junk[2], width=w, height=h,
                                  n_live=zero, slots=slots)
    g_s = tb.resolve_merge_kernel(ov_rows, ik, junk[2], width=w, height=h,
                                  n_live=n, slots=slots)
    torch.cuda.synchronize()
    won = ik >= 0
    assert float((gk - gp)[:, won].abs().max()) <= PLANE_TOL
    assert _equal(g_s[:, won], gk[:, won]) and _equal(g_s[:, ~won],
                                                      junk[2][:, ~won])
    assert _equal(g_0, junk[2])
    rows = tb.gather_stream(table, info.ids, poison).contiguous()
    seeded = dict(seeds=(zk, ik, gk), n_overflow=n, **kw)
    zs, is_, os_ = tb.fused_kernel(rows, info.bin_start, prm, **seeded)
    zsp, isp, osp = tb.fused_plain(rows, info.bin_start, prm, **seeded)
    torch.cuda.synchronize()
    assert _equal(is_, isp) and _equal(zs, zsp)
    assert float((os_ - osp).abs().max()) <= PLANE_TOL
    # The spill frame equals the spill-free one.
    assert _equal(is_, static[1]) and _equal(zs, static[0])
    assert float((os_ - static[2]).abs().max()) <= PLANE_TOL


def _k4_inputs(case):
    """K4's inputs as binned_pipeline makes them on a kmax=1 spill:
    (stream rows of the static overflow list, its slot map, the count,
    winner ids of K3 alone (the fused path's), winner ids of K5 then K3
    (binned_pipeline's, spilled and binned), channels, geometry)."""
    if case == "nine":
        rp = scenes.config4_camera(0.0, width=320, height=180,
                                   triangles=3000, device="cuda")
        setup, pv, _, _, _, _ = clip_inputs(rp)
        ps = fe.from_setup(setup)
        cols = fe.attr_corner_cols(pv)
        geo = dict(width=320, height=180, y_start=0)
    else:
        w, h, y0 = {"frame": (320, 192, 0), "ragged": (1917, 37, 0),
                    "band": (320, 96, 64)}[case]
        rp = scenes.config4_many_objects(0.0, width=w, height=h + 2 * y0,
                                         triangles=3000, device="cuda")
        ps, _, cols, _, _, _ = triangle_inputs(rp)
        geo = dict(width=w, height=h, y_start=y0)
    table, a, poison = fe.stream_table_planar(
        ps, fe.attribute_plane_cols(ps, cols))
    bbox = fe.bbox_table(ps)
    info = tb.build_bins(ps, kmax=1, **geo)
    ov, slots = tb.overflow_ids(info.overflow_mask)
    ov_rows = tb.gather_stream(table, ov, poison).contiguous()
    rec = tb.raster_records(ov_rows, bbox, ov)
    hw = (geo["height"], geo["width"])
    z0 = torch.full(hw, float("inf"), device="cuda")
    i0 = torch.full(hw, -1, dtype=torch.int32, device="cuda")
    _, i_ov = visibility_merge_kernel(rec, z0, i0, n_live=info.n_overflow,
                                      **geo)
    rows = tb.gather_stream(table, info.ids, poison).contiguous()
    zb, ib = tb.binned_vis_kernel(rows, info.bin_start, bbox=bbox, **geo)
    _, i_mix = visibility_merge_kernel(rec, zb, ib, n_live=info.n_overflow,
                                       **geo)
    return ov_rows, slots, int(info.n_overflow), i_ov, i_mix, a, geo


@pytest.mark.parametrize("case", ["frame", "ragged", "band", "nine"])
def test_resolve_merge_kernel_equals_plain_bit_for_bit(case):
    """K4 against its plain version, bit for bit, on the overflow
    winners of a kmax=1 spill: slots given and built by the wrapper,
    counts of 0, some and all rows (and no count), no seed, a seed out of
    place and in place, ids of K3 alone and of K5 then K3 (binned ids
    under the seed, which must stay), and those ids followed in memory by
    a spilled id; at 320x192, at 1917x37 (H*W % 4 = 1: the scalar tail),
    in the band of rows [64, 160) and at 9 channels."""
    ov_rows, slots, n, i_ov, i_mix, a, geo = _k4_inputs(case)
    h, w = geo["height"], geo["width"]
    assert n > 1 and bool((i_mix >= 0).any())
    assert (h * w % 4 != 0) == (case == "ragged")
    seed = torch.from_numpy(np.random.default_rng(5).random(
        (a, h, w), dtype=np.float32)).to("cuda")
    # The ids again, followed in memory by a spilled triangle's id: a read
    # past the frame's end would write its planes past the plane.
    fenced = torch.full((h * w + 64,), int(torch.nonzero(slots < n)[0]),
                        dtype=torch.int32, device="cuda")
    fenced[:h * w] = i_mix.reshape(-1)
    for tid in (i_ov, i_mix, fenced[:h * w].view(h, w)):
        q = tid.long()
        r = torch.where(q >= 0, slots[q.clamp(min=0)], ov_rows.shape[0])
        for live in (0, n // 2, n, None):
            n_live = (None if live is None else
                      torch.tensor(live, dtype=torch.int32, device="cuda"))
            won = r < (n if live is None else live)
            kw = dict(n_live=n_live, **geo)
            want = tb.resolve_merge_plain(ov_rows, tid, seed, slots=slots,
                                          **kw)
            bare = tb.resolve_merge_plain(ov_rows, tid, None, slots=slots,
                                          **kw)
            for sl in (slots, None):
                got = tb.resolve_merge_kernel(ov_rows, tid, seed, slots=sl,
                                              **kw)
                none = tb.resolve_merge_kernel(ov_rows, tid, None, slots=sl,
                                               **kw)
                buf = seed.clone()
                inplace = tb.resolve_merge_kernel(ov_rows, tid, buf,
                                                  slots=sl, inplace=True,
                                                  **kw)
                torch.cuda.synchronize()
                what = (case, tid is i_mix, live, sl is None)
                assert _equal(got, want), what
                assert inplace is buf and _equal(buf, want), what
                assert _equal(none[:, won], bare[:, won]), what
            assert _equal(want[:, ~won], seed[:, ~won])
            assert bool(won.any()) == (live != 0)
    binned = (i_mix >= 0) & (slots[i_mix.long().clamp(min=0)] >= n)
    assert bool(binned.any()), "no binned id under a seed: vacuous"


def _spill_transforms(rp):
    """Transforms of ``rp``: first one that moves the scene off the
    screen (nothing drawn, nothing spilled), then bench.py's rotation at
    three times, on which config 4's multi-bin triangles spill (with
    KMAX patched to a quarter: kmax 1 over 4 bands)."""
    off = tf.translation_matrix((5.0, 0.0, 0.0), device="cuda")
    axis = tf.normalize(torch.tensor([1.0, 1.0, 0.0], device="cuda"))
    rot = [tf.rotation_matrix(tf.quat_from_axis_angle(
        axis, torch.tensor(t, device="cuda"))) for t in (0.0, 1.0, 2.0)]
    return torch.stack([rp.transform @ off] + [rp.transform @ r
                                               for r in rot])


@pytest.mark.parametrize("mode", ["0", "1"])
def test_frame_graph_replays_spill_frames(mode, monkeypatch):
    """render_batch captures a frame with no spill and replays it on
    frames that spill: every frame equals its eager render bit for bit,
    the routes are one capture and the rest replays, and the launch
    counters advance on each replay as the eager frames' do. A second
    call with the same pass replays every frame, the first included,
    with the same frames and counters."""
    from software_renderer_tpu_torch.parallel import frame_graph as fg
    monkeypatch.setattr(ttex, "TEX_WINDOWED", mode)
    monkeypatch.setattr(tb, "KMAX", 0.25)
    rp = scenes.config4_many_objects(0.0, width=384, height=192,
                                     triangles=3000, device="cuda")
    ts = _spill_transforms(rp)
    spills = [int(_render_bins(dataclasses.replace(rp, transform=t))
                  .n_overflow) for t in ts]
    assert spills[0] == 0 and all(n > 0 for n in spills[1:]), spills
    render(rp)
    _cuda.reset_launches()
    eager = [render(dataclasses.replace(rp, transform=t)) for t in ts]
    torch.cuda.synchronize()
    want = dict(_cuda.launches)
    _cuda.reset_launches()
    fg.reset_routes()
    got = render_batch(rp, ts)
    torch.cuda.synchronize()
    assert fg.routes == {"capture": 1, "replay": len(ts) - 1, "eager": 0}
    assert dict(_cuda.launches) == want
    for i, e in enumerate(eager):
        assert _equal(got.color[i], e.color), i
        assert _equal(got.depth[i], e.depth), i
    _cuda.reset_launches()
    fg.reset_routes()
    again = render_batch(rp, ts)
    torch.cuda.synchronize()
    assert fg.routes == {"capture": 0, "replay": len(ts), "eager": 0}
    assert dict(_cuda.launches) == want
    for i, e in enumerate(eager):
        assert _equal(again.color[i], e.color), i
        assert _equal(again.depth[i], e.depth), i
    # One more replay through a FrameGraph adds one frame's launches.
    graph = fg.FrameGraph()
    graph(dataclasses.replace(rp, transform=ts[0]))
    before = dict(_cuda.launches)
    fb = graph(dataclasses.replace(rp, transform=ts[2]))
    torch.cuda.synchronize()
    assert _equal(fb.color, eager[2].color)
    assert _cuda.launches["fe"] == before["fe"] + 1
    assert _cuda.launches["fused"] == before["fused"] + 1
    assert _cuda.launches["visibility_merge"] == \
        before["visibility_merge"] + 1


def test_frame_graph_eager_routes_are_counted():
    """A texture that requires grad and the "adaptive" sampler render
    eagerly, counted; FrameLoop with a transform_fn replays, and its
    frames are its own (a later frame does not overwrite them);
    render_batch of camera frames (clip + perspective) replays them bit
    for bit."""
    from software_renderer_tpu_torch.parallel import frame_graph as fg
    from software_renderer_tpu_torch.utils.config import RenderConfig
    from software_renderer_tpu_torch.utils.display import FrameLoop
    rp = _config4_loop_scene(0.0)
    ts = torch.stack([_config4_loop_scene(t).transform
                      for t in (0.0, 0.5)])
    tex = dataclasses.replace(rp.texture, data=rp.texture.data.clone()
                              .requires_grad_(True))
    fg.reset_routes()
    render_batch(dataclasses.replace(rp, texture=tex), ts)
    saved = ttex.TEX_WINDOWED
    ttex.TEX_WINDOWED = "adaptive"
    try:
        render_batch(rp, ts)
    finally:
        ttex.TEX_WINDOWED = saved
    assert fg.routes == {"capture": 0, "replay": 0, "eager": 4}
    fg.reset_routes()
    loop = FrameLoop(lambda t: rp, lambda t: _config4_loop_scene(t).transform,
                     RenderConfig(width=256, height=192, time_step=0.5))
    frames = [loop.frame() for _ in range(3)]
    torch.cuda.synchronize()
    assert fg.routes == {"capture": 1, "replay": 2, "eager": 0}
    for i, fb in enumerate(frames):
        want = render(_config4_loop_scene(0.5 * i))
        assert _equal(fb.color, want.color) and _equal(fb.depth, want.depth)
    cam, ts, _ = _layer_case("camera", None)
    fg.reset_routes()
    got = render_batch(cam, ts)
    torch.cuda.synchronize()
    assert fg.routes["replay"] >= len(ts) - 1 and fg.routes["eager"] == 0
    for i, t in enumerate(ts):
        want = render(dataclasses.replace(cam, transform=t))
        assert _equal(got.color[i], want.color), i
        assert _equal(got.depth[i], want.depth), i


def test_profiling_trace_holds_spans_and_kernels(tmp_path):
    """profiling.trace around two main-path frames on the card writes a
    Chrome trace that holds sr.render once a frame, the layer spans and
    K2's launches."""
    import json
    from software_renderer_tpu_torch.utils import profiling
    rps = [_config4_loop_scene(t) for t in (0.0, 0.5)]
    render(rps[0])
    with profiling.trace(str(tmp_path)) as log_dir:
        for rp in rps:
            render(rp)
        torch.cuda.synchronize()
    with open(f"{log_dir}/{profiling.TRACE_FILE}") as f:
        events = json.load(f)["traceEvents"]
    spans = [e["name"] for e in events
             if e.get("name", "").startswith(profiling.PREFIX)]
    k2 = [e for e in events if e.get("cat") == "kernel"
          and "walk_kernel<true" in e.get("name", "")]
    assert spans.count("sr.render") == 2, spans
    assert {f"sr.{k}" for k in ("front", "bins", "spill", "raster",
                                "texture_tail")} <= set(spans), spans
    assert len(k2) >= 2, "no K2 launch in the trace"


def _replays_by_layer(fn):
    """``fn()`` under torch.profiler: per replay span of the program,
    (its layer map, the names of the device operations of the graph
    launch inside it, by start)."""
    import json
    import os
    import tempfile
    from software_renderer_tpu_torch.utils import profiling
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            evs = [e for e in json.load(f)["traceEvents"]
                   if e.get("ph") == "X"]
    finally:
        os.unlink(path)
    corr = lambda e: e.get("args", {}).get("correlation")
    ops = {}
    for e in evs:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            ops.setdefault(corr(e), []).append((e["ts"], e["name"]))
    launches = [e for e in evs if e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver")
                and "GraphLaunch" in e["name"]]
    out = []
    prefix = "sr.frame_graph.replay|"
    for sp in evs:
        if sp.get("cat") != "user_annotation" or \
                not sp["name"].startswith(prefix):
            continue
        layers = [(k, int(n)) for k, n in (p.split("=") for p in
                                           sp["name"][len(prefix):]
                                           .split("|"))]
        inside = [corr(e) for e in launches if e["tid"] == sp["tid"]
                  and sp["ts"] <= e["ts"] <= sp["ts"] + sp["dur"]]
        assert len(inside) == 1, inside
        out.append((layers, [n for _, n in sorted(ops.get(inside[0], []))]))
    assert profiling._map is None
    return out


def _layer_case(case, monkeypatch):
    """(RenderPass, [B, 4, 4] transforms, front layer) of a main-path,
    a spilling and a camera frame."""
    if case == "camera":
        rp = scenes.config4_camera(0.0, width=256, height=144,
                                   triangles=3000, device="cuda")
        ts = torch.stack([scenes.config4_camera(
            t, width=256, height=144, triangles=3000,
            device="cuda").transform for t in (0.0, 0.4, 0.8, 1.2)])
        return rp, ts, "clip_front"
    rp = scenes.config4_many_objects(0.0, width=384, height=192,
                                     triangles=3000, device="cuda")
    if case == "spill":
        monkeypatch.setattr(tb, "KMAX", 0.25)
        return rp, _spill_transforms(rp), "front"
    return rp, torch.stack([_config4_loop_scene(t).transform
                            for t in (0.0, 0.5, 1.0)]), "front"


@pytest.mark.parametrize("case", ["main", "spill", "camera"])
def test_replay_layer_map_matches_its_device_operations(case, monkeypatch):
    """Every profiled replay of render_batch runs as many device
    operations as its span's layer map counts, in the main path's layer
    order: K1 once in the front-end (nowhere on the clip path), the
    raster layer K2 alone, K3 and K4 in the spill layer."""
    rp, ts, front = _layer_case(case, monkeypatch)
    render_batch(rp, ts)
    replays = _replays_by_layer(lambda: render_batch(rp, ts))
    assert len(replays) == len(ts)
    for layers, ops in replays:
        names = [k for k, _ in layers]
        assert names == [front, "bins", "spill", "raster", "texture_tail"]
        assert sum(n for _, n in layers) == len(ops), (layers, len(ops))
        cut, k = {}, 0
        for layer, n in layers:
            cut[layer] = ops[k:k + n]
            k += n
        k1 = lambda part: sum("fe_kernel" in n for n in part)
        assert k1(ops) == k1(cut.get("front", [])) == (front == "front")
        assert len(cut["raster"]) == 1 and "walk_kernel" in \
            cut["raster"][0]
        assert any("resolve_merge_kernel" in n for n in cut["spill"])
        assert any("visibility_kernel" in n or "span_kernel" in n
                   for n in cut["spill"])


def _config4_full_frames():
    """Config 4 at full size (99,936 triangles, 1920x1080) on the card
    and two of bench.py's rotations of it."""
    rp = scenes.config4_many_objects(0.0, device="cuda")
    axis = tf.normalize(torch.tensor([1.0, 1.0, 0.0], device="cuda"))
    ts = torch.stack([rp.transform @ tf.rotation_matrix(
        tf.quat_from_axis_angle(axis, torch.tensor(t, device="cuda")))
        for t in (0.0, 0.5)])
    return rp, ts


def test_render_batch_memory_stays_flat_over_calls(monkeypatch):
    """300 render_batch calls of one pass at 1920x1080 on config 4's
    scene, from a fresh FrameGraph: the first call captures, the rest
    replay, and reserved device memory never rises above its level
    after the first call by more than that call added (a capture per
    call, each in a pool of its own, ran the card out at call 199 of
    batch64's 64-frame calls)."""
    from software_renderer_tpu_torch.parallel import batch
    from software_renderer_tpu_torch.parallel import frame_graph as fg
    monkeypatch.setattr(batch, "_graph", fg.FrameGraph())
    rp, ts = _config4_full_frames()
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    fg.reset_routes()
    render_batch(rp, ts)
    first = torch.cuda.memory_reserved()
    assert fg.routes["capture"] == 1
    top = first
    for _ in range(299):
        render_batch(rp, ts)
        top = max(top, torch.cuda.memory_reserved())
    torch.cuda.synchronize()
    assert fg.routes == {"capture": 1, "replay": 2 * 300 - 1, "eager": 0}
    assert top - first <= first - before, (before, first, top)


def test_render_batch_memory_is_bounded_over_many_passes(monkeypatch):
    """3 x MAX_CAPTURES passes of config 4 at 1920x1080, each with a
    texture of its own, through render_batch from a fresh FrameGraph:
    2 x MAX_CAPTURES evictions, and reserved device memory after the
    last pass within what the first pass added of its level after the
    first MAX_CAPTURES."""
    from software_renderer_tpu_torch.parallel import batch
    from software_renderer_tpu_torch.parallel import frame_graph as fg
    monkeypatch.setattr(batch, "_graph", fg.FrameGraph())
    rp, ts = _config4_full_frames()
    tex = rp.texture
    n = fg.MAX_CAPTURES
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    evicted = fg.evictions
    fg.reset_routes()
    reserved = []
    for _ in range(3 * n):
        own = ttex.Texture(tex.data.clone(), filter=tex.filter,
                           wrap=tex.wrap)
        render_batch(dataclasses.replace(rp, texture=own), ts)
        reserved.append(torch.cuda.memory_reserved())
    torch.cuda.synchronize()
    assert fg.routes == {"capture": 3 * n, "replay": 3 * n, "eager": 0}
    assert fg.evictions - evicted == 2 * n
    assert len(batch._graph._captures) == n
    one = reserved[0] - before
    assert max(reserved[n:]) - reserved[n - 1] <= one, (before, reserved)


def test_capture_layer_map_is_the_same_under_a_profiler(monkeypatch):
    """A capture records the same layer map with and without a profiler
    running, and with none running neither the capture nor a replay
    reaches record_function."""
    from software_renderer_tpu_torch.parallel import frame_graph as fg
    rp, ts, _ = _layer_case("main", monkeypatch)
    rps = [dataclasses.replace(rp, transform=t) for t in ts]

    def captured():
        graph = fg.FrameGraph()
        graph(rps[0])
        (cap,) = graph._captures.values()
        return graph, cap.layers

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        _, profiled = captured()
        torch.cuda.synchronize()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    graph, plain = captured()
    assert plain == profiled and sum(n for _, n in plain) > 0
    want = render(rps[2])
    fb = graph(rps[2])
    torch.cuda.synchronize()
    assert fg.routes["replay"] >= 1 and _equal(fb.color, want.color)


def _uhd_orbit(frames):
    """Config 4 at full size (99,936 triangles) in untextured Phong at
    3840x2160 on the card, and [len(frames), 4, 4] transforms of bench.py's
    orbit at those frames (frame / 60 s about (1, 1, 0)): the benchmark's
    ``config4_uhd_phong``. The culled pair budget spills about 12,600 triangles
    at frame 242 and none at frame 0."""
    rp = scenes.config4_many_objects(0.0, width=3840, height=2160,
                                     textured=False, device="cuda")
    axis = tf.normalize(torch.tensor([1.0, 1.0, 0.0], device="cuda"))
    ts = torch.stack([rp.transform @ tf.rotation_matrix(
        tf.quat_from_axis_angle(axis, torch.tensor(f / 60.0, device="cuda")))
        for f in frames])
    return rp, ts


def test_uhd_spill_kernels_match_plain():
    """On a 4K Phong frame whose budget spills more than 5,000 triangles,
    the main path's overflow pass (K3's merge from the clear seed, K4's
    resolve with no seed) and K2's seeded walk equal their plain versions:
    ids, coverage and depth bit for bit, planes within PLANE_TOL."""
    rp, ts = _uhd_orbit([242])
    rp = dataclasses.replace(rp, transform=ts[0])
    w, h = rp.width, rp.height
    ps, (table, a, poison) = planar_front_table_of(rp)
    chans, _, prm, lit, tex = shading_inputs(rp, with_attrs=False)
    info = tb.build_bins(ps, width=w, height=h, kmax=4 * tb.KMAX, bands=4,
                         pair_budget_factor=0.85)
    n = info.n_overflow
    assert int(n) >= 5000
    ov, slots = tb.overflow_ids(info.overflow_mask)
    ov_rows = tb.gather_stream(table, ov, poison).contiguous()
    bbox = fe.bbox_table(ps)
    rec = tb.raster_records(ov_rows, bbox, ov)
    z0 = torch.full((h, w), float("inf"), device="cuda")
    i0 = torch.full((h, w), -1, dtype=torch.int32, device="cuda")
    zk, ik = visibility_merge_kernel(rec, z0, i0, width=w, height=h,
                                     n_live=n)
    zp, ip = visibility_merge_plain(rec, z0, i0, width=w, height=h,
                                    n_live=n)
    torch.cuda.synchronize()
    assert int((ik >= 0).sum()) > 1_000_000
    assert _equal(ik, ip) and _equal(zk, zp)
    gk = tb.resolve_merge_kernel(ov_rows, ik, None, width=w, height=h,
                                 n_live=n, slots=slots)
    gp = tb.resolve_merge_plain(ov_rows, ik, None, width=w, height=h,
                                n_live=n, slots=slots)
    torch.cuda.synchronize()
    won = (ik >= 0).expand(a, h, w)
    assert float((gk - gp).abs()[won].max()) <= PLANE_TOL
    rows = tb.gather_stream(table, info.ids, poison).contiguous()
    kw = dict(width=w, height=h, chans=chans, has_light=lit, has_texture=tex,
              bands=4, bbox=bbox, seeds=(zk, ik, gk), n_overflow=n)
    zk2, ik2, ok2 = tb.fused_kernel(rows, info.bin_start, prm, **kw)
    zp2, ip2, op2 = tb.fused_plain(rows, info.bin_start, prm, **kw)
    torch.cuda.synchronize()
    assert _equal(ik2, ip2) and _equal(zk2, zp2)
    assert float((ok2 - op2).abs().max()) <= PLANE_TOL


def test_uhd_replay_equals_eager_and_counts_its_spills():
    """4K Phong frames replayed from one capture equal the same frames
    rendered eagerly, bit for bit, with no host sync; and the spill
    counter counts the replayed frames' spills by reason as it counts the
    eager frames'."""
    from software_renderer_tpu_torch.parallel import frame_graph as fg
    rp, ts = _uhd_orbit([0, 242, 616])
    rps = [dataclasses.replace(rp, transform=t) for t in ts]
    graph = fg.FrameGraph()
    graph(rps[0])
    eager = []
    tb.reset_spill_counts("cuda")
    for r in rps[1:]:
        fb = render(r)
        eager.append((fb.color.clone(), fb.depth.clone()))
    want = tb.spill_counts("cuda")
    tb.reset_spill_counts("cuda")
    fg.reset_routes()
    replayed = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for r in rps[1:]:
            fb = graph(r)
            replayed.append((fb.color.clone(), fb.depth.clone()))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    got = tb.spill_counts("cuda")
    assert fg.routes["replay"] == 2
    assert want["frames"] == 2 and want["budget"] > 10_000, want
    assert got == want
    for (ce, de), (cr, dr) in zip(eager, replayed):
        assert _equal(ce, cr) and _equal(de, dr)


def test_render_batch_memory_stays_flat_at_uhd(monkeypatch):
    """50 render_batch calls of the 4K Phong cell's shapes (32 frames at
    a stride of 22 over the orbit, each call one frame later), from a
    fresh FrameGraph: one capture, every other frame replayed, and
    reserved device memory never above its level after the first call
    by more than that call added."""
    from software_renderer_tpu_torch.parallel import batch
    from software_renderer_tpu_torch.parallel import frame_graph as fg
    monkeypatch.setattr(batch, "_graph", fg.FrameGraph())
    rp, ts = _uhd_orbit(range(704 + 49))
    torch.cuda.synchronize()
    before = torch.cuda.memory_reserved()
    fg.reset_routes()
    render_batch(rp, ts[0:704:22])
    first = torch.cuda.memory_reserved()
    top = first
    for k in range(1, 50):
        render_batch(rp, ts[k:k + 704:22])
        top = max(top, torch.cuda.memory_reserved())
    torch.cuda.synchronize()
    assert fg.routes == {"capture": 1, "replay": 32 * 50 - 1, "eager": 0}
    assert top - first <= first - before, (before, first, top)


# ---------------------------------------------------------------------------
# The texture tail kernel (csrc/tail.cu): finish_fused in one launch on
# every frame that needs no gradient.
# ---------------------------------------------------------------------------

_TAIL_PLANS = {"lit_spec_uv": [("lit", 3), ("spec", 1), ("uv", 2)],
               "rgb_uv": [("rgb", 3), ("uv", 2)],
               "final": [("final", 3)], "rgb": [("rgb", 3)]}


def _tail_case(plan, c, wrap, h, w, seed=5):
    """Fused output planes of ``plan`` on an [h, w] frame with ~30% of
    its pixels uncovered (their planes hold values the mask must drop),
    u and v in [-2.5, 3.5) (negative, past 1 and inside), the ids, a
    random 64x48 texture of ``c`` channels and the default light, on the
    card."""
    g = torch.Generator().manual_seed(seed)
    chans = _TAIL_PLANS[plan]
    n = sum(s for _, s in chans)
    out = torch.rand((n, h, w), generator=g)
    if "uv" in dict(chans):
        out[-2:] = out[-2:] * 6.0 - 2.5
    tid = torch.randint(0, 1000, (h, w), generator=g, dtype=torch.int32)
    tid[torch.rand((h, w), generator=g) < 0.3] = -1
    tex = ttex.Texture(data=torch.rand((48, 64, c), generator=g).cuda(),
                       wrap=wrap)
    return out.cuda(), tid.cuda(), chans, Light.default("cuda"), tex


def _bits(t):
    return t.contiguous().view(torch.int32)


_TAIL_CASES = ([(p, c, wrap, hw) for p in ("lit_spec_uv", "rgb_uv")
                for c in (1, 3, 4) for wrap in ("repeat", "clamp")
                for hw in ((1080, 1920), (77, 203))]
               + [(p, 3, "repeat", hw) for p in ("final", "rgb")
                  for hw in ((1080, 1920), (77, 203))])


@pytest.mark.parametrize("plan,c,wrap,hw", _TAIL_CASES)
def test_tail_kernel_equals_finish_fused(plan, c, wrap, hw):
    """The tail kernel's RGBA equals finish_fused's on the same card
    inputs bit for bit: every plan it serves, textures of 1, 3 and 4
    channels, both wraps, u and v outside [0, 1], at 1920x1080 and at a
    width that is a multiple of neither 4 nor 128; one launch."""
    out, tid, chans, light, tex = _tail_case(plan, c, wrap, *hw)
    assert tsh.tail_kernel_plan(out, chans, light, tex) is not None
    _cuda.reset_launches()
    k = tsh.tail_kernel(out, tid, out_chans=chans, light=light, texture=tex)
    p = tsh.finish_fused(out, tid != -1, out_chans=chans, light=light,
                         texture=tex)
    torch.cuda.synchronize()
    assert _cuda.launches["tail"] == 1
    assert k.shape == (*hw, 4) and k.is_contiguous()
    assert bool((k[..., 3] == (tid != -1).float()).all())
    assert torch.equal(_bits(k), _bits(p))


def _plain_tail(monkeypatch):
    """Route every frame's texture tail to finish_fused."""
    monkeypatch.setattr(tsh, "tail_kernel_plan", lambda *a, **kw: None)


@pytest.mark.parametrize("case", ["config4", "band", "camera", "phong"])
def test_tail_kernel_frames_equal_the_torch_tail(case, monkeypatch):
    """Frames through render/render_rows with the tail kernel equal the
    same frames with finish_fused's torch tail, bit for bit: config 4 cut
    down, a band of it (rows [37, 87)), the camera path (clip and
    perspective-correct attributes, K2 dividing by w) and config 4 in
    untextured Phong (the 4K cell's plan at a small size); one tail
    launch a frame, none with the torch tail."""
    from software_renderer_tpu_torch.render import render_rows
    if case == "camera":
        rp = scenes.config4_camera(0.5, width=256, height=144,
                                   triangles=3000, device="cuda")
    elif case == "phong":
        rp = scenes.config4_many_objects(0.0, width=200, height=136,
                                         triangles=3000, textured=False,
                                         device="cuda")
    else:
        rp = _config4_loop_scene(0.5)
    fn = ((lambda: render_rows(rp, 37, 50)) if case == "band"
          else (lambda: render(rp)))
    _cuda.reset_launches()
    fb = fn()
    torch.cuda.synchronize()
    assert _cuda.launches["tail"] == 1 and _cuda.launches["fused"] == 1
    assert bool(fb.color[..., 3].any())
    with monkeypatch.context() as m:
        _plain_tail(m)
        _cuda.reset_launches()
        want = fn()
        torch.cuda.synchronize()
        assert _cuda.launches["tail"] == 0
    assert torch.equal(_bits(fb.color), _bits(want.color))
    assert _equal(fb.depth, want.depth)


def test_tail_kernel_replayed_frames_equal_eager_and_count(monkeypatch):
    """render_batch captures a frame with the tail kernel and replays it:
    every frame equals its eager render bit for bit (the eager frames
    through finish_fused too), and the tail launches once a frame on
    render, render_batch and FrameLoop, as K2 does."""
    from software_renderer_tpu_torch.parallel import batch
    from software_renderer_tpu_torch.parallel import frame_graph as fg
    from software_renderer_tpu_torch.utils.config import RenderConfig
    from software_renderer_tpu_torch.utils.display import FrameLoop
    monkeypatch.setattr(batch, "_graph", fg.FrameGraph())
    rp = _config4_loop_scene(0.0)
    ts = torch.stack([_config4_loop_scene(0.5 * i).transform
                      for i in range(4)])
    rps = [dataclasses.replace(rp, transform=t) for t in ts]
    _cuda.reset_launches()
    eager = [render(r).color for r in rps]
    torch.cuda.synchronize()
    assert _cuda.launches["tail"] == 4 and _cuda.launches["fused"] == 4
    with monkeypatch.context() as m:
        _plain_tail(m)
        plain = [render(r).color for r in rps]
    for _ in range(2):  # the capture's call, then a call of replays only
        fg.reset_routes()
        _cuda.reset_launches()
        got = render_batch(rp, ts)
        torch.cuda.synchronize()
        assert fg.routes["eager"] == 0 and fg.routes["replay"] >= 3
        assert _cuda.launches["tail"] == 4 and _cuda.launches["fused"] == 4
        for i in range(4):
            assert torch.equal(_bits(got.color[i]), _bits(eager[i])), i
            assert torch.equal(_bits(got.color[i]), _bits(plain[i])), i
    loop = FrameLoop(lambda t: rp, lambda t: _config4_loop_scene(t).transform,
                     RenderConfig(width=256, height=192, time_step=0.5))
    _cuda.reset_launches()
    frames = [loop.frame().color.clone() for _ in range(3)]
    torch.cuda.synchronize()
    assert _cuda.launches["tail"] == 3 and _cuda.launches["fused"] == 3
    for i, f in enumerate(frames):
        assert torch.equal(_bits(f), _bits(eager[i])), i


@pytest.mark.parametrize("case", ["train", "trilinear", "nearest",
                                  "route1", "adaptive"])
def test_tail_kernel_is_not_launched_off_its_path(case, monkeypatch):
    """No tail launch where finish_fused keeps the frame: a texture
    training step (the gradient flows through the tail), trilinear and
    nearest filters, and the windowed routes "1" and "adaptive"; K2
    still launches every frame."""
    rp = _config4_loop_scene(0.0)
    _cuda.reset_launches()
    if case == "train":
        ts = torch.stack([_config4_loop_scene(0.5 * i).transform
                          for i in range(2)])
        targets = torch.rand((2, rp.height, rp.width, 4), device="cuda")
        texture_train_step(rp.texture.data, rp, ts, targets, lr=5000.0)
    elif case in ("trilinear", "nearest"):
        render(dataclasses.replace(rp, texture=ttex.Texture(
            data=rp.texture.data, filter=case, wrap=rp.texture.wrap)))
    else:
        monkeypatch.setattr(ttex, "TEX_WINDOWED",
                            "1" if case == "route1" else "adaptive")
        render(rp)
    torch.cuda.synchronize()
    assert _cuda.launches["fused"] >= 1
    assert _cuda.launches["tail"] == 0, dict(_cuda.launches)


def test_tail_kernel_raises_on_bad_input():
    out, tid, chans, light, tex = _tail_case("lit_spec_uv", 3, "repeat",
                                             16, 24)
    kw = dict(out_chans=chans, light=light, texture=tex)
    with pytest.raises(ValueError):
        tsh.tail_kernel(out[:5], tid, **kw)
    with pytest.raises(ValueError):
        tsh.tail_kernel(out, tid[:8], **kw)
    with pytest.raises(TypeError):
        tsh.tail_kernel(out, tid.long(), **kw)
    with pytest.raises(ValueError):
        tsh.tail_kernel(out, tid, out_chans=[("normal", 3)], light=light,
                        texture=tex)
    with pytest.raises(ValueError):
        tsh.tail_kernel(out, tid, out_chans=chans, light=light,
                        texture=ttex.Texture(data=tex.data,
                                             filter="nearest"))
