"""PyTorch port, the bin build with static shapes and device counts
against the JAX package, and the count-aware plain versions of K2, K3
and K4.

The port's ``build_bins`` has JAX's static shapes: ``ids`` holds JAX's
``pairs_cap`` slots with a -1 tail, ``n_overflow`` stays a 0-d tensor,
and the overflow list is JAX's ``overflow_id_waves`` as one wave. Both
packages bin one shared PlanarSetup (the JAX front-end's, carried across
with convert.planar_setup_from_numpy), so the per-bin lists, the
overflow mask and the counts are compared exactly. The kernels' plain
versions take the device count: at 0, K2 is its static walk bit for bit
and K3/K4 return their seeds unchanged; rows past the count are inert.
A frame whose every triangle spills goes through ``render`` and stays in
the typed classes against JAX ``render(..., "reference")``.

Small sizes only (T < 4096: JAX keeps its XLA front-end), no Pallas
interpret mode; the JAX bin build runs under ``jax.jit``.
"""
from functools import partial

import jax
import numpy as np
import pytest
import torch

import software_renderer_tpu as sr
from software_renderer_tpu.models import scenes as jscenes
from software_renderer_tpu.ops import binning as jbin
from software_renderer_tpu.ops import frontend as jfe
from software_renderer_tpu.testing.compare import assert_tie_class_equal
import software_renderer_tpu_torch as srt
from software_renderer_tpu_torch import convert
from software_renderer_tpu_torch.models import scenes as tscenes
from software_renderer_tpu_torch.ops import binning as tbin
from software_renderer_tpu_torch.ops import frontend as tfe
from software_renderer_tpu_torch.ops.rasterize_kernel import (
    visibility_merge_plain)
from software_renderer_tpu_torch.render import triangle_inputs

torch.set_num_threads(1)

W, H = 320, 192


@pytest.fixture(scope="module")
def c4():
    """config 4 at 320x192 with ~3000 triangles: (JAX PlanarSetup, the
    shared torch PlanarSetup)."""
    rp = jscenes.config4_many_objects(0.0, width=W, height=H,
                                      triangles=3000)
    tris = rp.mesh.triangles()
    ps_j = jfe.planar_front(jfe.corner_cols(rp.mesh.positions[tris]),
                            rp.transform, W, H,
                            cull_backfaces=rp.cull_backfaces, pallas=False)
    return ps_j, convert.planar_setup_from_numpy(ps_j, device="cpu")


@pytest.fixture(scope="module")
def c4_port():
    """The port's own config 4 at 320x192: (PlanarSetup, stream table,
    channels, params)."""
    rp = tscenes.config4_many_objects(0.0, width=W, height=H,
                                      triangles=3000, device="cpu")
    ps, chans, attrs, prm, _, _ = triangle_inputs(rp)
    table = tfe.stream_table_planar(ps, tfe.attribute_plane_cols(ps, attrs))
    return ps, table, chans, prm


def _lists(ids, bin_start):
    return {b: ids[bin_start[b]:bin_start[b + 1]].tolist()
            for b in range(len(bin_start) - 1)
            if bin_start[b + 1] > bin_start[b]}


def _jax_lists(info, bands, chunk=128, glen=16):
    ids = np.asarray(info.ids)
    ct = np.asarray(info.chunk_tile)
    gb = np.asarray(info.group_band) if bands > 1 else None
    lists = {}
    for s in np.nonzero(ids >= 0)[0]:
        b = int(ct[s // chunk]) * bands + (int(gb[s // glen]) if bands > 1
                                           else 0)
        lists.setdefault(b, []).append(int(ids[s]))
    return lists


@pytest.mark.parametrize("bands,kmax,budget", [(4, 48, 0.85), (4, 4, 0.1),
                                               (1, 12, 1.5)])
def test_static_bins_match_jax(c4, bands, kmax, budget):
    ps_j, ps_t = c4
    kw = dict(width=W, height=H, chunk=128, kmax=kmax,
              pair_budget_factor=budget, bands=bands)
    info_j = jax.jit(partial(jbin.build_bins, glen=16, **kw))(ps_j)
    info_t = tbin.build_bins(ps_t, **kw)
    t = ps_t.num_triangles
    budget_pairs = -(int(-budget * t) // 128) * 128
    pairs_cap = min(budget_pairs, -(-(t * kmax) // 128) * 128)
    ids = info_t.ids.numpy()
    live = int(info_t.bin_start[-1])
    assert info_t.ids.dtype == torch.int32 and ids.shape == (pairs_cap,)
    assert (ids[:live] >= 0).all() and (ids[live:] == -1).all()
    assert 0 < live <= pairs_cap
    assert info_t.n_overflow.dtype == torch.int32
    assert info_t.n_overflow.shape == ()
    assert int(info_t.n_overflow) == int(info_j.n_overflow)
    if budget < 0.5:
        assert int(info_t.n_overflow) > 0, "nothing spilled: vacuous"
    np.testing.assert_array_equal(np.asarray(info_j.overflow_mask),
                                  info_t.overflow_mask.numpy())
    lists = _lists(ids, info_t.bin_start.numpy())
    assert lists == _jax_lists(info_j, bands)
    assert all(np.all(np.diff(v) > 0) for v in lists.values())
    # The overflow list: JAX's overflow_id_waves as one chunk-padded wave.
    cap = -(-t // 128) * 128
    ov, _ = tbin.overflow_ids(info_t.overflow_mask)
    assert ov.dtype == torch.int32 and ov.shape == (cap,)
    np.testing.assert_array_equal(
        np.asarray(jbin.overflow_id_waves(info_j, cap)), ov.numpy())


def test_overflow_ids_edges():
    """Ascending ids then -1 for masks with nothing, everything and a
    random half spilled, lengths padded to the chunk; the slot map sends
    each spilled triangle to its row and every other one to the list's
    length."""
    rng = np.random.default_rng(3)
    for mask in (np.zeros(5, bool), np.ones(130, bool),
                 rng.random(300) < 0.5, np.zeros(0, bool)):
        ov, slots = tbin.overflow_ids(torch.from_numpy(mask), chunk=64)
        ov, slots = ov.numpy(), slots.numpy()
        n = int(mask.sum())
        cap = max(-(-mask.size // 64), 1) * 64
        assert ov.shape == (cap,)
        np.testing.assert_array_equal(ov[:n], np.nonzero(mask)[0])
        assert (ov[n:] == -1).all()
        assert slots.dtype == np.int32 and slots.shape == mask.shape
        np.testing.assert_array_equal(slots[ov[:n]], np.arange(n))
        assert (slots[~mask] == cap).all()


def _seeds(a, fill):
    z, i, g = fill
    return (torch.full((H, W), z), torch.full((H, W), i, dtype=torch.int32),
            torch.full((a, H, W), g))


def test_fused_plain_count(c4_port):
    """K2's plain version: with the count at 0 it is the static walk bit
    for bit whatever the seeds hold; above 0 it is the seeded walk."""
    ps, (table, a, poison), chans, prm = c4_port
    info = tbin.build_bins(ps, width=W, height=H, kmax=48,
                           pair_budget_factor=0.85, bands=4)
    assert int(info.n_overflow) == 0
    rows = tbin.gather_stream(table, info.ids, poison)
    kw = dict(bbox=tfe.bbox_table(ps), width=W, height=H, chans=chans,
              has_light=True, has_texture=True, bands=4)
    static = tbin.fused_plain(rows, info.bin_start, prm, **kw)
    junk = _seeds(a, (-5.0, 7, 3.0))
    counted = tbin.fused_plain(rows, info.bin_start, prm, seeds=junk,
                               n_overflow=info.n_overflow, **kw)
    for s, c in zip(static, counted):
        assert torch.equal(s, c)
    one = torch.ones((), dtype=torch.int32)
    seeded = tbin.fused_plain(rows, info.bin_start, prm, seeds=junk,
                              n_overflow=one, **kw)
    assert not torch.equal(seeded[0], static[0]), "seeds unread: vacuous"


def test_merge_plains_count(c4_port):
    """K3's and K4's plain versions: at a count of 0 they return their
    seeds; rows past the count change nothing; the static list with its
    count equals the compact list."""
    ps, (table, a, poison), _, _ = c4_port
    info = tbin.build_bins(ps, width=W, height=H, kmax=1,
                           pair_budget_factor=0.85, bands=4)
    n = info.n_overflow
    assert int(n) > 0
    ov, _ = tbin.overflow_ids(info.overflow_mask)
    ov_rows = tbin.gather_stream(table, ov, poison)
    rec = tbin.raster_records(ov_rows, tfe.bbox_table(ps), ov)
    # The static list's rows are the spilled triangles' records.
    compact = tfe.pack_records_planar(ps, 128)[
        torch.nonzero(info.overflow_mask).squeeze(1)]
    assert torch.equal(rec[:int(n)], compact)
    z0, i0, _ = _seeds(a, (float("inf"), -1, 0.0))
    zj, ij, gj = _seeds(a, (-5.0, 7, 3.0))
    zero = torch.zeros((), dtype=torch.int32)
    z, i = visibility_merge_plain(rec, zj, ij, width=W, height=H,
                                  n_live=zero)
    assert torch.equal(z, zj) and torch.equal(i, ij)
    assert torch.equal(tbin.resolve_merge_plain(ov_rows, ij, gj, width=W,
                                                height=H, n_live=zero), gj)
    # The static list's rows past the count are not read.
    z3, i3 = visibility_merge_plain(rec, z0, i0, width=W, height=H,
                                    n_live=n)
    zc, ic = visibility_merge_plain(compact, z0, i0, width=W, height=H)
    assert torch.equal(z3, zc) and torch.equal(i3, ic)
    assert bool((i3 >= 0).any())
    g4 = tbin.resolve_merge_plain(ov_rows, i3, None, width=W, height=H,
                                  n_live=n)
    assert torch.equal(g4, tbin.resolve_merge_plain(
        ov_rows[:int(n)], i3, torch.zeros((a, H, W)), width=W, height=H))
    assert bool((g4 != 0).any())


def test_merge_plain_slots_match_search(monkeypatch):
    """K4's plain version through the slot map equals the search of the
    live rows' sorted ids (``_write_planes``, the previous lookup) on the
    spill scene below: with the map from ``overflow_ids``, with the map
    built from the rows, out of place and in place, at counts of all the
    rows, some and none."""
    rp = tscenes.config2_textured_cube(0.7, width=128, height=96,
                                       device="cpu")
    ps, _, attrs, _, _, _ = triangle_inputs(rp)
    table, a, poison = tfe.stream_table_planar(
        ps, tfe.attribute_plane_cols(ps, attrs))
    monkeypatch.setattr(tbin, "KMAX", 0.25)
    info = tbin.build_bins(ps, width=128, height=96, kmax=tbin.KMAX)
    n = int(info.n_overflow)
    assert n == int(ps.valid.sum()) > 1
    ov, slots = tbin.overflow_ids(info.overflow_mask)
    rows = tbin.gather_stream(table, ov, poison)
    # The seed ids hold a triangle that did not spill (a culled one) on
    # every other column, as binned_pipeline's do.
    kept = int(torch.nonzero(~info.overflow_mask)[0])
    i0 = torch.where(torch.arange(128) % 2 == 0, kept, -1).to(
        torch.int32).expand(96, 128).contiguous()
    geo = dict(width=128, height=96)
    _, tid = visibility_merge_plain(
        tbin.raster_records(rows, tfe.bbox_table(ps), ov),
        torch.full((96, 128), float("inf")), i0, n_live=info.n_overflow,
        **geo)
    assert bool((tid >= 0).any()) and bool((tid == kept).any())
    seed = torch.from_numpy(
        np.random.default_rng(1).random((a, 96, 128), dtype=np.float32))
    for live in (n, n // 2, 0):
        n_live = torch.tensor(live, dtype=torch.int32)
        q = tid.reshape(-1)
        want = tbin._write_planes(
            seed.clone(), rows[:live], rows[:live, tbin.REC_BASE - 1].to(
                torch.int32).contiguous(), q, q >= 0, y_start=0)
        for sl in (slots, None):
            got = tbin.resolve_merge_plain(rows, tid, seed, n_live=n_live,
                                           slots=sl, **geo)
            assert torch.equal(got, want), (live, sl is None)
        inplace = seed.clone()
        got = tbin.resolve_merge_kernel(rows, tid, inplace, n_live=n_live,
                                        slots=slots, inplace=True, **geo)
        assert got is inplace and torch.equal(got, want)
        # Rows past the count are never read.
        assert torch.equal(want, seed) == (live == 0), live


def test_spill_frame_render_matches_jax_reference(monkeypatch):
    """Every triangle spills (kmax below one bin): the frame goes through
    the overflow kernels and the seeded fused walk inside render(), and
    stays in the typed classes against JAX's reference render."""
    rp = jscenes.config2_textured_cube(0.7, width=128, height=96)
    port = convert.render_pass_from_numpy(
        convert.arrays_of(rp), device="cpu", **convert.static_fields_of(rp))
    ps = triangle_inputs(port)[0]
    monkeypatch.setattr(tbin, "KMAX", 0.25)
    info = tbin.build_bins(ps, width=128, height=96, kmax=tbin.KMAX)
    assert int(info.n_overflow) == int(ps.valid.sum()) > 0
    fb_t = srt.render(port)
    fb_j = sr.render(rp, backend="reference")
    cj, dj = np.asarray(fb_j.color), np.asarray(fb_j.depth)
    ct, dt = fb_t.color.numpy(), fb_t.depth.numpy()
    assert ct[..., 3].any()
    np.testing.assert_array_equal(cj[..., 3], ct[..., 3])
    assert_tie_class_equal(cj, ct, dj, dt, atol=1e-3, context="spill")
