"""PyTorch port, bins and the fused pipeline against the JAX package.

Both packages run on one shared PlanarSetup (the JAX front-end's output
carried across with convert.planar_setup_from_numpy), so coverage
decisions are identical by construction and these comparisons are
exact: per-bin id lists, overflow masks, winner ids. Depths agree within
the FMA-contraction class (XLA:CPU may contract the depth plane's
multiply-adds; torch rounds each operation). Shaded planes are compared
at atol 1e-4: the same contraction ulps, amplified by the specular pow.

The JAX bin build, fused pipeline and resolve run under one ``jax.jit``
each (``_jit``): the same computation as one XLA program, which the
persistent compilation cache keeps between runs, instead of op-by-op
dispatch. The front-end and the reference visibility pass stay op by op:
under jit XLA:CPU contracts their multiply-adds into FMAs, which moves
coverage at a few edge pixels.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from software_renderer_tpu.models import scenes as jscenes
from software_renderer_tpu.ops import binning as jbin
from software_renderer_tpu.ops import frontend as jfe
from software_renderer_tpu.ops import shading as jsh
from software_renderer_tpu.ops.rasterize_ref import visibility_ref
from software_renderer_tpu.ops.resolve import (barycentrics_at_pixels,
                                               interpolate_attribute)
from software_renderer_tpu_torch import _cuda, convert
from software_renderer_tpu_torch.ops import binning as tbin
from software_renderer_tpu_torch.ops import frontend as tfe
from software_renderer_tpu_torch.ops.rasterize_kernel import (
    visibility_merge_plain)

torch.set_num_threads(1)


def _jit(fn, **static):
    """``fn`` with the keyword arguments ``static`` bound, under one
    jax.jit."""
    return jax.jit(partial(fn, **static))


def _scene(rp):
    """(JAX PlanarSetup, shared torch PlanarSetup, JAX planar attrs,
    torch attrs, chans, JAX params, torch params, has_light) of a JAX
    RenderPass, through the JAX planar front-end."""
    mesh = rp.mesh
    tris = mesh.triangles()
    ps_j = jfe.planar_front(jfe.corner_cols(mesh.positions[tris]),
                            rp.transform, rp.width, rp.height,
                            cull_backfaces=rp.cull_backfaces, pallas=False)
    has_light = rp.light is not None
    chans = jsh.attribute_channels(rp.shading, True, has_light)
    vals = {"rgb": mesh.colors, "normal": mesh.normals, "uv": mesh.uvs}
    attrs_j = []
    for name, _ in chans:
        attrs_j += jfe.attr_corner_cols(vals[name][tris])
    attrs_t = [tuple(torch.from_numpy(np.array(c)) for c in a)
               for a in attrs_j]
    prm_j = jsh.shading_params(rp.light, flat_color=rp.flat_color)
    return (ps_j, convert.planar_setup_from_numpy(ps_j, device="cpu"),
            attrs_j, attrs_t, chans, prm_j, torch.from_numpy(np.array(prm_j)),
            has_light)


def _assert_depth_class(depth_j, depth_t, ids, ps):
    """Depth of the same winner, equal up to the FMA-contraction class:
    XLA:CPU may fuse ``zx * x + zy * y + zc`` into multiply-adds that
    torch (and the CUDA kernels, built with --fmad=false) round
    separately. Bound: 4 ulps of the chain's magnitude at the pixel."""
    depth_t = depth_t.numpy()
    np.testing.assert_array_equal(np.isfinite(depth_j), np.isfinite(depth_t))
    cov = ids.numpy() >= 0
    win = ids.numpy()[cov]
    yy, xx = np.nonzero(cov)
    mag = (np.abs(ps.zx.numpy()[win] * (xx + 0.5))
           + np.abs(ps.zy.numpy()[win] * (yy + 0.5))
           + np.abs(ps.zc.numpy()[win]))
    err = np.abs(depth_j[cov].astype(np.float64) - depth_t[cov])
    assert (err <= 2.0 ** -21 * mag).all(), (err.max(), int((err > 0).sum()))


def _jax_bin_lists(info, bands, chunk=128, glen=16):
    ids = np.asarray(info.ids)
    ct = np.asarray(info.chunk_tile)
    lists = {}
    for s in np.nonzero(ids >= 0)[0]:
        b = int(ct[s // chunk]) * bands
        if bands > 1:
            b += int(np.asarray(info.group_band)[s // glen])
        lists.setdefault(b, []).append(int(ids[s]))
    return lists


def _torch_bin_lists(info):
    bs = info.bin_start.numpy()
    ids = info.ids.numpy()
    return {b: ids[bs[b]:bs[b + 1]].tolist() for b in range(len(bs) - 1)
            if bs[b + 1] > bs[b]}


@pytest.fixture(scope="module")
def c4():
    """config4 at 320x192 with ~3000 triangles (between 2048 and 4095:
    the port takes its banded path, JAX keeps its XLA front-end)."""
    rp = jscenes.config4_many_objects(0.0, width=320, height=192,
                                      triangles=3000)
    return rp, _scene(rp)


@pytest.fixture(scope="module")
def c4_ref(c4):
    """The JAX reference visibility pass of ``c4``'s setup: (array
    setup, depth, ids)."""
    rp, (ps_j, *_rest) = c4
    s_j = jfe.to_setup(ps_j)
    dj, ij = visibility_ref(s_j, width=rp.width, height=rp.height)
    return s_j, np.asarray(dj), np.asarray(ij)


@pytest.mark.parametrize("bands,budget", [(1, 1.5), (4, 0.85), (4, 0.1)])
def test_build_bins_matches_jax(c4, bands, budget):
    rp, (ps_j, ps_t, *_rest) = c4
    assert 2048 <= ps_t.num_triangles < 4096
    kw = dict(width=rp.width, height=rp.height, chunk=128, kmax=12 * bands,
              pair_budget_factor=budget, bands=bands)
    info_j = _jit(jbin.build_bins, glen=16, **kw)(ps_j)
    info_t = tbin.build_bins(ps_t, **kw)
    np.testing.assert_array_equal(np.asarray(info_j.overflow_mask),
                                  info_t.overflow_mask.numpy())
    assert int(info_t.n_overflow) == int(info_j.n_overflow)
    if budget < 0.5:
        assert int(info_t.n_overflow) > 0, "budget did not spill; vacuous"
    lists_t = _torch_bin_lists(info_t)
    assert lists_t == _jax_bin_lists(info_j, bands)
    assert all(np.all(np.diff(v) > 0) for v in lists_t.values())


def _run_port(ps_t, attrs_t, prm_t, rp, chans, has_light, **kw):
    return tbin.fused_pipeline(ps_t, attrs_t, prm_t, width=rp.width,
                               height=rp.height, chans=chans,
                               has_light=has_light, has_texture=True, **kw)


def test_fused_plain_matches_jax_interpret():
    """The one interpret-mode JAX fused run (config2 at 192x128, a 2x2
    tile grid)."""
    rp = jscenes.config2_textured_cube(0.7, width=192, height=128)
    ps_j, ps_t, attrs_j, attrs_t, chans, prm_j, prm_t, hl = _scene(rp)
    out_chans = jsh.fused_output_channels(rp.shading, chans, hl, True)
    dj, ij, oj = _jit(
        jbin.fused_pipeline, width=rp.width, height=rp.height,
        epilogue=partial(jsh.fused_epilogue, chans=chans, has_light=hl,
                         has_texture=True),
        n_out=sum(s for _, s in out_chans), chunk=16)(ps_j, attrs_j, prm_j)
    # chunk=16 keeps the interpreter's unrolled kernel bodies small; it is
    # pure layout in JAX and, in both packages, the budget rounding unit.
    dt, it, ot = _run_port(ps_t, attrs_t, prm_t, rp, chans, hl, chunk=16)
    assert bool((it >= 0).any())
    np.testing.assert_array_equal(np.asarray(ij), it.numpy())
    _assert_depth_class(np.asarray(dj), dt, it, ps_t)
    np.testing.assert_allclose(np.asarray(oj), ot.numpy(), atol=1e-4)


@pytest.mark.parametrize("which", ["config2", "config4"])
def test_fused_all_spill_equals_binned(c4, which):
    """kmax=1 sends every multi-bin triangle through the overflow kernels
    and the seeded fused walk; the frame must equal the default run."""
    if which == "config2":
        rp = jscenes.config2_textured_cube(0.7, width=192, height=128)
        sc = _scene(rp)
    else:
        rp, sc = c4
    _, ps_t, _, attrs_t, chans, _, prm_t, hl = sc
    d0, i0, o0 = _run_port(ps_t, attrs_t, prm_t, rp, chans, hl)
    bands = 4 if ps_t.num_triangles >= 2048 else 1
    info = tbin.build_bins(ps_t, width=rp.width, height=rp.height, kmax=1,
                           bands=bands)
    assert int(info.n_overflow) > 0
    d1, i1, o1 = _run_port(ps_t, attrs_t, prm_t, rp, chans, hl, kmax=1)
    np.testing.assert_array_equal(i0.numpy(), i1.numpy())
    np.testing.assert_array_equal(d0.numpy(), d1.numpy())
    np.testing.assert_array_equal(o0.numpy(), o1.numpy())


def test_fused_ids_depth_match_visibility_ref(c4, c4_ref):
    rp, (_, ps_t, _, attrs_t, chans, _, prm_t, hl) = c4
    _, dj, ij = c4_ref
    dt, it, _ = _run_port(ps_t, attrs_t, prm_t, rp, chans, hl,
                          pair_budget_factor=0.85)
    assert bool((it >= 0).any())
    np.testing.assert_array_equal(ij, it.numpy())
    _assert_depth_class(dj, dt, it, ps_t)


def test_overflow_kernels_plain_match_jax(c4, c4_ref):
    """visibility_merge over every record into a clear buffer is the
    reference visibility pass; resolve_merge's planes equal the JAX
    barycentric resolve (algebraically equal, atol 1e-4)."""
    rp, (_, ps_t, attrs_j, attrs_t, chans, _, _, _) = c4
    s_j, dj, ij = c4_ref
    w, h = rp.width, rp.height
    rec = tfe.pack_records_planar(ps_t, 128)
    z0 = torch.full((h, w), float("inf"))
    i0 = torch.full((h, w), -1, dtype=torch.int32)
    zt, it = visibility_merge_plain(rec, z0, i0, width=w, height=h)
    np.testing.assert_array_equal(ij, it.numpy())
    _assert_depth_class(dj, zt, it, ps_t)
    ij = jnp.asarray(ij)

    table, a, poison = tfe.stream_table_planar(
        ps_t, tfe.attribute_plane_cols(ps_t, attrs_t))
    valid_ids = torch.nonzero(ps_t.valid).squeeze(1).to(torch.int32)
    rows = tbin.gather_stream(table, valid_ids, poison)
    gb = tbin.resolve_merge_plain(rows, it, torch.zeros((a, h, w)),
                                  width=w, height=h)
    attrs = jnp.stack([jnp.stack(v, axis=-1) for v in attrs_j], axis=-1)
    ws, cov = jax.jit(barycentrics_at_pixels)(s_j, ij)
    gj = np.asarray(jax.jit(interpolate_attribute)(attrs, ij, ws, cov))
    assert bool(np.asarray(cov).any())
    np.testing.assert_allclose(np.moveaxis(gj, -1, 0), gb.numpy(),
                               atol=1e-4)


def test_cpu_tensors_run_plain_versions_without_launches(c4):
    rp, (_, ps_t, _, attrs_t, chans, _, prm_t, hl) = c4
    _cuda.reset_launches()
    _run_port(ps_t, attrs_t, prm_t, rp, chans, hl, kmax=1)
    assert all(v == 0 for v in _cuda.launches.values()), _cuda.launches


def _uhd_orbit_setup(frame, triangles=3000):
    """The port's planar setup of config 4's scene at 3840x2160 under
    bench.py's orbit frame ``frame`` (a turn of frame / 60 s about
    (1, 1, 0)); at 3000 triangles frame 240 spills about a third of its
    valid triangles past the culled budget, frame 0 nothing."""
    from software_renderer_tpu_torch.models import scenes as tscenes
    from software_renderer_tpu_torch.ops import transforms as ttf
    from software_renderer_tpu_torch.render import planar_front_of
    rp = tscenes.config4_many_objects(0.0, width=3840, height=2160,
                                      triangles=triangles, textured=False,
                                      device="cpu")
    q = ttf.quat_from_axis_angle(ttf.normalize(torch.tensor([1.0, 1.0, 0.0])),
                                 torch.tensor(frame / 60.0))
    return planar_front_of(
        dataclasses.replace(rp, transform=rp.transform
                            @ ttf.rotation_matrix(q))), rp


def _spill_rule(ps, width, height, *, kmax, budget_factor, bands,
                chunk=128):
    """build_bins' overflow rule, on the host in numpy, by reason: the
    triangles that are valid and not coverage-safe, safe ones spanning
    more than ``kmax`` (tile, band) bins, and the rest past the pair
    budget in id order."""
    col = lambda name: getattr(ps, name).numpy()
    valid, safe = col("valid"), col("safe")
    bh = 64 // bands
    nb = -(-height // 64) * bands
    ty0 = np.clip(col("by0") // bh, 0, nb - 1)
    ty1 = np.clip(col("by1") // bh, 0, nb - 1)
    nspan = ((col("bx1") // 128 - col("bx0") // 128 + 1)
             * (ty1 - ty0 + 1)).astype(np.int64)
    small = valid & safe & (nspan <= kmax)
    t = valid.shape[0]
    budget = -(-int(budget_factor * t) // chunk) * chunk
    past = small & (np.cumsum(np.where(small, nspan, 0)) > budget)
    return {"budget": int(past.sum()),
            "kmax": int((valid & safe & (nspan > kmax)).sum()),
            "unsafe": int((valid & ~safe).sum())}


@pytest.mark.parametrize("frame,kmax", [(240, 12), (0, 12), (480, 12),
                                        (240, 1)])
def test_spill_counter_counts_the_rule_by_reason(frame, kmax):
    """Each bin build adds its spills by reason to its device's counter:
    the culled budget at frame 240 (about 454 of 1,275 valid triangles),
    nothing at frame 0, a few triangles that are not coverage-safe at
    frame 480, and with kmax = 1 tile the triangles spanning more bins
    (render's arguments otherwise)."""
    ps, rp = _uhd_orbit_setup(frame)
    w, h, bands = rp.width, rp.height, 4
    kw = dict(kmax=kmax * bands, budget_factor=0.85, bands=bands)
    want = _spill_rule(ps, w, h, **kw)
    tbin.reset_spill_counts("cpu")
    before = tbin.spill_counts("cpu")
    info = tbin.build_bins(ps, width=w, height=h, kmax=kmax * bands,
                           pair_budget_factor=0.85, bands=bands)
    tbin.build_bins(ps, width=w, height=h, kmax=kmax * bands,
                    pair_budget_factor=0.85, bands=bands)
    got = tbin.spill_counts("cpu")
    assert before == dict(frames=0, budget=0, kmax=0, unsafe=0)
    assert got == dict(frames=2, **{k: 2 * v for k, v in want.items()})
    assert sum(want.values()) == int(info.n_overflow)
    if kmax == 1:
        assert want["kmax"] > 0
    elif frame == 240:
        assert want["budget"] >= 0.25 * int(ps.valid.sum())
    if frame == 0:
        assert int(info.n_overflow) == 0
    if frame == 480:
        assert want["unsafe"] > 0
    tbin.reset_spill_counts()
    assert tbin.spill_counts("cpu")["frames"] == 0


def test_spill_counter_reads_nothing_on_the_host(monkeypatch):
    """A bin build adds to the counter without reading a tensor on the
    host (on the card, tests/test_torch_cuda.py runs the frame under
    ``set_sync_debug_mode("error")``)."""
    ps, rp = _uhd_orbit_setup(240)

    def refuse(*a, **k):
        raise AssertionError("a host read inside build_bins")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__",
                 "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    tbin.reset_spill_counts("cpu")
    info = tbin.build_bins(ps, width=rp.width, height=rp.height, kmax=48,
                           pair_budget_factor=0.85, bands=4)
    monkeypatch.undo()
    assert tbin.spill_counts("cpu")["budget"] == int(info.n_overflow) > 0
